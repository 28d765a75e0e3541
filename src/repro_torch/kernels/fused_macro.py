"""The fused seq-KWN macro: tile planning and the kernel wrapper.

Counterpart of ``repro.kernels.fused_macro`` (``TilePlan``,
``plan_tiles``, and ``fused_macro_seq`` in KWN mode).  The kernel is
``csrc/fused_macro_seq_kwn.cu``, a hand-written CUDA kernel for Hopper
that replaces the Pallas ``_seq_kwn_kernel``: per time step the twin-cell
ternary MAC, the ramp codes with optional Fig. 7 counter noise, the KWN
descending priority sweep, the LUT drive and the LIF update with SNL, the
membrane carried across T in registers.

``fused_macro_seq`` takes operands already padded to a ``TilePlan``
(``kernels.ops.fused_macro_seq`` does the padding).  A CUDA tensor
launches the kernel, and ``fused_macro_seq.launches`` counts the
launches; a CPU tensor runs the plain version ``kernels.ref``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

DEFAULT_BM = 128
DEFAULT_BK = 256   # the macro's row count: one K-tile == one physical macro
DEFAULT_BN = 128   # the macro's column count: one col-tile == one macro width
MAX_COLS = 1024    # widest layer the kernel takes (32 columns per lane)


class TilePlan(NamedTuple):
    """Padded geometry for one fused launch (see ``repro`` for the
    field contract).  ``bm``/``bk`` are also the occupancy-map
    granularity: one word per (step, row tile, K tile)."""

    bm: int
    bk: int
    bn: int
    m_pad: int
    k_pad: int
    n_pad: int
    nc_pad: int
    n_valid: int
    grid: tuple[int, int, int, int]   # (M/bm, T, NC/bn, K/bk)

    @property
    def activity_shape(self) -> tuple[int, int, int]:
        """(T, row-tiles, K-tiles): one occupancy word per gateable block."""
        return (self.grid[1], self.grid[0], self.grid[3])


def _ceil_mult(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


def plan_tiles(m: int, k_dim: int, nc: int, n: int, t: int = 1) -> TilePlan:
    """The reference's heuristic KWN tile plan (no plan cache).

    Row tiles follow the batch (``min(128, ceil_to_8(M))``); K tiles are
    the 256-row macro, or the smallest 128-multiple covering a narrower
    layer; a layer wider than one 128-column macro is padded to whole
    column tiles.
    """
    bm_ = min(DEFAULT_BM, _ceil_mult(m, 8))
    bk_ = DEFAULT_BK if k_dim >= DEFAULT_BK else _ceil_mult(k_dim, 128)
    if nc <= DEFAULT_BN:
        bn_ = nc
        n_pad, nc_pad = n, nc
    else:
        bn_ = DEFAULT_BN
        nc_pad = _ceil_mult(nc, bn_)
        n_pad = nc_pad
    m_pad = _ceil_mult(m, bm_)
    k_pad = _ceil_mult(k_dim, bk_)
    return TilePlan(bm=bm_, bk=bk_, bn=bn_, m_pad=m_pad, k_pad=k_pad,
                    n_pad=n_pad, nc_pad=nc_pad, n_valid=nc,
                    grid=(m_pad // bm_, t, nc_pad // bn_, k_pad // bk_))


class _Params(ctypes.Structure):
    """Mirror of ``FmskParams`` in ``csrc/fused_macro_seq_kwn.cu``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "msb", "lsb", "bounds", "levels", "scale", "v0", "noise",
        "activity", "row_ctl", "mac", "v_out", "spikes", "mask", "steps")] + [
        (name, ctypes.c_int) for name in (
            "t_steps", "m", "k_dim", "n", "n_valid", "k", "n_codes", "bm",
            "bk", "use_snl", "noisy")] + [
        (name, ctypes.c_float) for name in (
            "ratio", "drive_gain", "beta", "v_th1", "v_th2", "v_reset",
            "v_lim", "snl_amp", "offset_lsb", "sigma_lsb", "inl_lsb",
            "in_lo", "in_span")]


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _launch(x, msb, lsb, boundaries, levels, scale, v, noise, activity,
            row_ctl, *, k, ratio, drive_gain, beta, v_th1, v_th2, v_reset,
            v_lim, use_snl, bm, bk, n_valid, ima_noise, snl_amp,
            mac_telemetry):
    dev = x.device
    t_steps, m, k_dim = x.shape
    n = msb.shape[1]
    n_codes = levels.shape[0]
    if n > MAX_COLS:
        raise ValueError(f"fused seq-KWN kernel takes at most {MAX_COLS} "
                         f"columns, got {n}")
    if m % 4 or bm % 4 or k_dim % bk or bk % 32:
        raise ValueError(f"unsupported padding: m={m} bm={bm} "
                         f"k_dim={k_dim} bk={bk}")
    f32, i32 = torch.float32, torch.int32

    def operand(a, dtype, shape):
        if a.device != dev or a.dtype != dtype or not a.is_contiguous() \
                or tuple(a.shape) != tuple(shape):
            raise ValueError(f"kernel operand must be a contiguous {dtype} "
                             f"{tuple(shape)} tensor on {dev}; got "
                             f"{a.dtype} {tuple(a.shape)} on {a.device}")
        return a

    ops = dict(
        x=operand(x, torch.int8, (t_steps, m, k_dim)),
        msb=operand(msb, torch.int8, (k_dim, n)),
        lsb=operand(lsb, torch.int8, (k_dim, n)),
        bounds=operand(boundaries, f32, (n_codes - 1,)),
        levels=operand(levels, f32, (n_codes,)),
        scale=operand(scale, f32, (n,)),
        v0=operand(v, f32, (m, n)),
        noise=None if noise is None else operand(noise, f32,
                                                 (t_steps, m, n)),
        activity=None if activity is None else operand(
            activity, i32, (t_steps, m // bm, k_dim // bk)),
        row_ctl=operand(row_ctl, i32, (m, 3)))
    outs = dict(
        mac=torch.empty((t_steps, m, n), dtype=f32, device=dev)
        if mac_telemetry else None,
        v_out=torch.empty((m, n), dtype=f32, device=dev),
        spikes=torch.empty((t_steps, m, n), dtype=f32, device=dev),
        mask=torch.empty((t_steps, m, n), dtype=f32, device=dev),
        steps=torch.empty((t_steps, m, 1), dtype=i32, device=dev))
    nz = ima_noise
    params = _Params(
        **{name: _ptr(a) for name, a in {**ops, **outs}.items()},
        t_steps=t_steps, m=m, k_dim=k_dim, n=n, n_valid=n_valid, k=k,
        n_codes=n_codes, bm=bm, bk=bk, use_snl=int(use_snl),
        noisy=int(nz is not None), ratio=ratio, drive_gain=drive_gain,
        beta=beta, v_th1=v_th1, v_th2=v_th2, v_reset=v_reset, v_lim=v_lim,
        snl_amp=snl_amp,
        offset_lsb=0.0 if nz is None else nz.offset_lsb,
        sigma_lsb=0.0 if nz is None else nz.sigma_lsb,
        inl_lsb=0.0 if nz is None else nz.inl_lsb,
        in_lo=0.0 if nz is None else nz.in_lo,
        # folded in f64, cast once to f32 (as the reference does)
        in_span=1.0 if nz is None else nz.in_hi - nz.in_lo + 1e-9)
    lib = build.library("fused_macro_seq_kwn")
    fn = lib.fmsk_launch
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.byref(params), stream)
    if err != 0:
        raise RuntimeError(f"fused_macro_seq_kwn launch failed: CUDA error "
                           f"{err}")
    fused_macro_seq.launches += 1
    return (outs["mac"], outs["v_out"], outs["spikes"], outs["mask"],
            outs["steps"])


def fused_macro_seq(x, msb, lsb, boundaries, levels, scale, v, noise=None,
                    activity=None, row_ctl=None, *, k: int = 12,
                    ratio: float = 2.0, drive_gain: float = 1.0,
                    beta: float = 0.9, v_th1: float = 1.0,
                    v_th2: float = 0.6, v_reset: float = 0.0,
                    v_lim: float = 8.0, use_snl: bool = True,
                    bm: int = DEFAULT_BM, bk: int = DEFAULT_BK,
                    n_valid: int | None = None, ima_noise=None,
                    snl_amp: float = 0.0, mac_telemetry: bool = True,
                    seed=0, step_offset=0):
    """A whole fused KWN event sequence in one launch (padded operands).

    x (T, M, K) int8, msb/lsb (K, N) int8, boundaries (n_codes - 1,),
    levels (n_codes,), scale (N,), v (M, N) f32, noise (T, M, N) f32 or
    None (counter streams), activity (T, M/bm, K/bk) int32 or None,
    row_ctl (M, 3) int32 or None.  M is a multiple of ``bm`` and K of
    ``bk``.  Without ``row_ctl`` each row uses ``[seed, step_offset,
    absolute row]``: the stream of the reference's scalar path.

    Returns (mac (T, M, N) or None, v_out (M, N), spikes (T, M, N),
    mask (T, M, N), adc_steps (T, M, 1) int32).
    """
    m, n = x.shape[1], msb.shape[1]
    n_valid = n if n_valid is None else n_valid
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if row_ctl is None:
        rows = torch.arange(m, dtype=torch.int32, device=x.device)
        row_ctl = torch.stack([torch.full_like(rows, int(seed)),
                               torch.full_like(rows, int(step_offset)),
                               rows], dim=-1)
    kw = dict(k=k, ratio=ratio, drive_gain=drive_gain, beta=beta,
              v_th1=v_th1, v_th2=v_th2, v_reset=v_reset, v_lim=v_lim,
              use_snl=use_snl, ima_noise=ima_noise, snl_amp=snl_amp,
              mac_telemetry=mac_telemetry)
    if x.is_cuda:
        return _launch(x, msb, lsb, boundaries, levels, scale, v, noise,
                       activity, row_ctl.contiguous(), bm=bm, bk=bk,
                       n_valid=n_valid, **kw)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return ref.fused_macro_seq_ref(x, msb, lsb, boundaries, levels, scale,
                                   v, noise, row_ctl=row_ctl,
                                   n_valid=n_valid, **kw)


fused_macro_seq.launches = 0
