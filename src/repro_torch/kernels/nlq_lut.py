"""The NLQ ramp conversion and LUT kernel: the composed chain's second
stage.

Counterpart of ``repro.kernels.nlq_lut`` (``nlq_convert``, the Pallas
kernel ``_nlq_kernel``).  The hand-written CUDA kernel ``csrc/nlq_lut.cu``
replaces it: four values a thread, loaded before the codebook (in each
warp's registers up to 64 codes, else in shared memory); the code, the
count of boundaries strictly below, by a binary search where the
boundaries are sorted and by the linear count where not; the
reconstruction a gather (the Pallas one-hot sum, whose other terms are
zeros).

A CUDA tensor launches the kernel, counted in ``nlq_convert.launches``; a
CPU tensor runs the plain version ``kernels.ref.nlq_convert_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_macro import _operand, _run


class _Params(ctypes.Structure):
    """Mirror of ``NlqParams`` in ``csrc/nlq_lut.cu``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "bounds", "levels", "codes", "recon")] + [
        ("total", ctypes.c_longlong), ("n_codes", ctypes.c_int)]


def nlq_convert(x: torch.Tensor, boundaries: torch.Tensor,
                levels: torch.Tensor):
    """x (M, N) f32, boundaries (n_codes - 1,), levels (n_codes,) f32 ->
    (codes (M, N) int32, reconstruction (M, N) f32)."""
    if x.device.type == "cpu":
        return ref.nlq_convert_ref(x, boundaries, levels)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    dev = x.device
    n_codes = levels.shape[0]
    f32 = torch.float32
    x = _operand(x, f32, x.shape, dev)
    boundaries = _operand(boundaries, f32, (n_codes - 1,), dev)
    levels = _operand(levels, f32, (n_codes,), dev)
    codes = x.new_empty(x.shape, dtype=torch.int32)
    recon = x.new_empty(x.shape)
    params = _Params(x=x.data_ptr(), bounds=boundaries.data_ptr(),
                     levels=levels.data_ptr(), codes=codes.data_ptr(),
                     recon=recon.data_ptr(), total=x.numel(),
                     n_codes=n_codes)
    _run("nlq_lut", "nlq_launch", params, dev)
    nlq_convert.launches += 1
    return codes, recon


nlq_convert.launches = 0
