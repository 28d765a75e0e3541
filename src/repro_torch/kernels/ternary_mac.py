"""The twin-cell ternary MAC kernel: the composed chain's first stage.

Counterpart of ``repro.kernels.ternary_mac`` (``ternary_mac``, the Pallas
kernel ``_ternary_mac_kernel``).  The hand-written CUDA kernel
``csrc/ternary_mac.cu`` replaces it: a warp a row and 128 columns, the
fused kernels' event-driven MAC (a ballot over 32 inputs, only the plane
rows of the inputs that fired) in int32 for both planes, then
``fmaf(ratio, acc_msb, acc_lsb)``.  It masks ragged shapes itself, so its
wrapper pads nothing.

A CUDA tensor launches the kernel, counted in ``ternary_mac.launches``; a
CPU tensor runs the plain version ``kernels.ref.ternary_mac_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_macro import _operand, _run


class _Params(ctypes.Structure):
    """Mirror of ``TmacParams`` in ``csrc/ternary_mac.cu``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "msb", "lsb", "out")] + [
        (name, ctypes.c_int) for name in ("m", "k_dim", "n")] + [
        ("ratio", ctypes.c_float)]


def ternary_mac(x: torch.Tensor, msb: torch.Tensor, lsb: torch.Tensor,
                ratio: float = 2.0) -> torch.Tensor:
    """x (M, K) int8 ternary, msb / lsb (K, N) int8 ternary -> (M, N) f32
    ``x @ (ratio * msb + lsb)``."""
    if x.device.type == "cpu":
        return ref.ternary_mac_ref(x, msb, lsb, ratio)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    dev = x.device
    m, k_dim = x.shape
    n = msb.shape[1]
    i8 = torch.int8
    x = _operand(x, i8, (m, k_dim), dev)
    msb = _operand(msb, i8, (k_dim, n), dev)
    lsb = _operand(lsb, i8, (k_dim, n), dev)
    out = x.new_empty((m, n), dtype=torch.float32)
    params = _Params(x=x.data_ptr(), msb=msb.data_ptr(), lsb=lsb.data_ptr(),
                     out=out.data_ptr(), m=m, k_dim=k_dim, n=n, ratio=ratio)
    _run("ternary_mac", "tmac_launch", params, dev)
    ternary_mac.launches += 1
    return out


ternary_mac.launches = 0
