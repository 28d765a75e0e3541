"""The elementwise LIF kernel: the composed chain's last stage.

Counterpart of ``repro.kernels.lif_step`` (``lif_step_fused``, the Pallas
kernel ``_lif_kernel``).  The hand-written CUDA kernel ``csrc/lif_step.cu``
replaces it: one pass over (v, drive, mask, noise), 16-byte vector loads
when every operand is aligned, the fused kernels' LIF update (winners
``fmaf(beta, v, drive)``, SNL kick, clip, compare, reset).

A CUDA tensor launches the kernel, counted in ``lif_step_fused.launches``;
a CPU tensor runs the plain version ``kernels.ref.lif_step_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_macro import _operand, _run


class _Params(ctypes.Structure):
    """Mirror of ``LifStepParams`` in ``csrc/lif_step.cu``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "v", "drive", "mask", "noise", "v_out", "spikes")] + [
        ("total", ctypes.c_longlong), ("use_snl", ctypes.c_int),
        ("vec4", ctypes.c_int)] + [
        (name, ctypes.c_float) for name in (
            "beta", "v_th1", "v_th2", "v_reset", "v_lim")]


def lif_step_fused(v: torch.Tensor, drive: torch.Tensor, mask: torch.Tensor,
                   noise: torch.Tensor, beta: float = 0.9,
                   v_th1: float = 1.0, v_th2: float = 0.6,
                   v_reset: float = 0.0, v_lim: float = 8.0,
                   use_snl: bool = True):
    """All operands (M, N) f32; returns (v_out, spikes), both (M, N) f32."""
    if v.device.type == "cpu":
        return ref.lif_step_ref(v, drive, mask, noise, beta=beta, v_th1=v_th1,
                                v_th2=v_th2, v_reset=v_reset, v_lim=v_lim,
                                use_snl=use_snl)
    if not v.is_cuda:
        raise ValueError(f"unsupported device {v.device}")
    dev = v.device
    shape, f32 = v.shape, torch.float32
    ptrs = [_operand(a, f32, shape, dev).data_ptr()
            for a in (v, drive, mask, noise)]
    v_out = v.new_empty(shape)
    spikes = v.new_empty(shape)
    ptrs += [v_out.data_ptr(), spikes.data_ptr()]
    vec4 = all(ptr % 16 == 0 for ptr in ptrs)
    params = _Params(*ptrs, total=v.numel(), use_snl=int(use_snl),
                     vec4=int(vec4), beta=beta, v_th1=v_th1, v_th2=v_th2,
                     v_reset=v_reset, v_lim=v_lim)
    _run("lif_step", "lif_launch", params, dev)
    lif_step_fused.launches += 1
    return v_out, spikes


lif_step_fused.launches = 0
