"""The KWN top-K kernel with ramp early stop: the composed chain's third
stage.

Counterpart of ``repro.kernels.kwn_topk`` (``kwn_topk``, the Pallas kernel
``_kwn_kernel``).  The hand-written CUDA kernel ``csrc/kwn_topk.cu``
replaces it: one warp per row, the row's MAC loaded (16 bytes a lane
where the row allows) while the codebook is staged, the ramp codes, then
a select with a fixed cost: the K-th winner's code found bit by bit in
``ceil(log2 n_codes)`` warp-wide counts, ties admitted in column order by
a prefix popcount.  ``K <= 0`` reports step 0 as the TPU kernel's full
sweep does.  Any width up to ``MAX_COLS`` columns.

A CUDA tensor launches the kernel, counted in ``kwn_topk.launches``; a CPU
tensor runs the plain version ``kernels.ref.kwn_topk_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_macro import MAX_COLS, _operand, _run


class _Params(ctypes.Structure):
    """Mirror of ``KwnParams`` in ``csrc/kwn_topk.cu``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "mac", "bounds", "mask", "steps")] + [
        (name, ctypes.c_int) for name in ("m", "n", "k", "n_codes")]


def kwn_topk(mac: torch.Tensor, boundaries: torch.Tensor, k: int):
    """mac (M, N) f32, boundaries (n_codes - 1,) f32 -> (mask (M, N) f32,
    adc_steps (M, 1) int32)."""
    if mac.device.type == "cpu":
        return ref.kwn_topk_ref(mac, boundaries, k)
    if not mac.is_cuda:
        raise ValueError(f"unsupported device {mac.device}")
    dev = mac.device
    m, n = mac.shape
    if n > MAX_COLS:
        raise ValueError(f"the KWN kernel takes at most {MAX_COLS} columns, "
                         f"got {n}")
    n_codes = boundaries.shape[0] + 1
    f32 = torch.float32
    mac = _operand(mac, f32, (m, n), dev)
    boundaries = _operand(boundaries, f32, (n_codes - 1,), dev)
    mask = mac.new_empty((m, n))
    steps = mac.new_empty((m, 1), dtype=torch.int32)
    params = _Params(mac=mac.data_ptr(), bounds=boundaries.data_ptr(),
                     mask=mask.data_ptr(), steps=steps.data_ptr(), m=m, n=n,
                     k=int(k), n_codes=n_codes)
    _run("kwn_topk", "kwn_launch", params, dev)
    kwn_topk.launches += 1
    return mask, steps


kwn_topk.launches = 0
