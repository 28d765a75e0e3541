"""The surrogate backward of the fused KWN sequence: the kernel's wrapper.

Counterpart of ``repro.kernels.fused_macro_grad`` (``fused_macro_seq_grad``,
the Pallas kernel ``_seq_kwn_bwd_kernel``).  The hand-written CUDA kernel
``csrc/fused_macro_seq_kwn_bwd.cu`` replaces it: a reverse-time pass (one
warp per row and 32 columns, the membrane cotangent in a register) writes
``g_mac`` and ``dv0``, then an event-driven contraction sums
``dW = sum_t x_t^T g_mac_t`` in a fixed order, without atomics.

The wrapper takes operands already padded to the forward's ``TilePlan``
(``kernels.ops.seq_grad_operands`` pads them).  A CUDA tensor
launches the kernel, counted in ``fused_macro_seq_grad.launches``; a CPU
tensor runs the plain version ``kernels.ref.fused_macro_seq_grad_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_macro import _operand, _ptr, _run


class _BwdParams(ctypes.Structure):
    """Mirror of ``FmskBwdParams`` in ``csrc/fused_macro_seq_kwn_bwd.cu``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "scale", "g_spk", "g_vfin", "vtrace", "mask", "mac", "msb",
        "lsb", "activity", "g_mac", "dw", "dv0")] + [
        (name, ctypes.c_int) for name in (
            "t_steps", "m", "k_dim", "n", "bm")] + [
        (name, ctypes.c_float) for name in (
            "ratio", "drive_gain", "beta", "v_th1", "v_lim", "kwn_relax",
            "surrogate_beta", "ste_lo", "ste_hi")]


def _launch(x, scale, g_spk, g_vfin, vtrace, mask, mac, msb, lsb, activity,
            **kw):
    dev = x.device
    t_steps, m, k_dim = x.shape
    n = vtrace.shape[-1]
    bm = m if activity is None else m // max(activity.shape[1], 1)
    if k_dim % 32 or (activity is not None and activity.shape[1] * bm != m):
        raise ValueError(f"unsupported padding: m={m} k_dim={k_dim} bm={bm}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    f32, i32 = torch.float32, torch.int32
    stack = (t_steps, m, n)
    ops = dict(
        x=_operand(x, torch.int8, (t_steps, m, k_dim), dev),
        scale=_operand(scale, f32, (n,), dev),
        g_spk=_operand(g_spk, f32, stack, dev),
        g_vfin=_operand(g_vfin, f32, (m, n), dev),
        vtrace=_operand(vtrace, f32, stack, dev),
        mask=_operand(mask, f32, stack, dev),
        mac=None if mac is None else _operand(mac, f32, stack, dev),
        msb=None if msb is None else _operand(msb, torch.int8, (k_dim, n),
                                              dev),
        lsb=None if lsb is None else _operand(lsb, torch.int8, (k_dim, n),
                                              dev),
        activity=None if activity is None else _operand(
            activity, i32, (t_steps, m // bm), dev))
    outs = dict(g_mac=torch.empty(stack, dtype=f32, device=dev),
                dw=torch.empty((k_dim, n), dtype=f32, device=dev),
                dv0=torch.empty((m, n), dtype=f32, device=dev))
    params = _BwdParams(
        **{name: _ptr(a) for name, a in {**ops, **outs}.items()},
        t_steps=t_steps, m=m, k_dim=k_dim, n=n, bm=bm, **kw)
    _run("fused_macro_seq_kwn_bwd", "fmskb_launch", params, dev)
    fused_macro_seq_grad.launches += 1
    return outs["dw"], outs["dv0"]


def fused_macro_seq_grad(x, scale, g_spk, g_vfin, vtrace, mask, mac=None,
                         msb=None, lsb=None, activity=None, *,
                         ratio: float = 2.0, drive_gain: float = 1.0,
                         beta: float = 0.9, v_th1: float = 1.0,
                         v_lim: float = 8.0, kwn_relax: float = 0.0,
                         surrogate_beta: float = 4.0, ste_lo: float = -24.5,
                         ste_hi: float = 24.5):
    """The fused surrogate backward on padded operands, one launch.

    x (T, M, K) int8 ternary (K a multiple of 32), scale (N,) f32 (padded
    columns 0), g_spk / vtrace / mask (T, M, N) f32, g_vfin (M, N) f32,
    mac (T, M, N) f32 MAC residual or None with the (K, N) int8 planes
    ``msb`` / ``lsb`` to recompute it (the same bits either way), activity
    (T, M / bm) int32 row-tile occupancy or None (dense).

    Returns (dW (K, N) f32, dv0 (M, N) f32): the cotangents of the
    integer-unit weight and the initial membrane.
    """
    if (mac is None) == (msb is None or lsb is None):
        raise ValueError("pass either the MAC residual or both planes")
    kw = dict(ratio=ratio, drive_gain=drive_gain, beta=beta, v_th1=v_th1,
              v_lim=v_lim, kwn_relax=kwn_relax,
              surrogate_beta=surrogate_beta, ste_lo=ste_lo, ste_hi=ste_hi)
    if x.is_cuda:
        return _launch(x, scale, g_spk, g_vfin, vtrace, mask, mac, msb, lsb,
                       activity, **kw)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return ref.fused_macro_seq_grad_ref(x, scale, g_spk, g_vfin, vtrace,
                                        mask, mac, msb, lsb, activity, **kw)


fused_macro_seq_grad.launches = 0
