"""The fused macro kernels: tile planning and the kernel wrappers.

Counterpart of ``repro.kernels.fused_macro`` (``TilePlan``,
``plan_tiles``, ``fused_macro_seq`` in both modes, ``LayerSpec`` and
``fused_macro_multi_seq``).  Three hand-written CUDA kernels for Hopper
replace the Pallas kernels (the backward of the first is in
``kernels.fused_macro_grad``):

* ``csrc/fused_macro_seq_kwn.cu`` (``_seq_kwn_kernel``): per time step the
  twin-cell ternary MAC, the ramp codes with optional Fig. 7 counter
  noise, the KWN descending priority sweep, the LUT drive and the LIF
  update with SNL, the membrane carried across T in registers, and for
  training the saturated membrane of every step (``train_trace``);
* ``csrc/fused_macro_seq_nld.cu`` (``_seq_nld_kernel``): the same MAC,
  ``mac * scale``, the activation ramp with optional noise, the LUT, the
  branch-major soma combine with ``w_dend`` and a dense LIF without SNL;
* ``csrc/fused_macro_multi_seq_kwn.cu`` (``_multi_seq_kwn_kernel``): L
  stacked KWN layers per step, the spikes handed from layer to layer in
  registers.

The wrappers take operands already padded to a ``TilePlan``
(``kernels.ops`` does the padding).  A CUDA tensor launches the kernel,
and each wrapper's ``launches`` attribute counts its launches; a CPU
tensor runs the plain version in ``kernels.ref``.
"""

from __future__ import annotations

import ctypes
import math
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


def plan_tiles(m: int, k_dim: int, nc: int, n: int, t: int = 1, *,
               mode: str = "kwn", n_branches: int = 1) -> TilePlan:
    """The reference's heuristic tile plan (no plan cache).

    Row tiles follow the batch (``min(128, ceil_to_8(M))``); K tiles are
    the 256-row macro, or the smallest 128-multiple covering a narrower
    layer; a layer wider than one 128-column macro is padded to whole
    column tiles.  In NLD mode (``nc == n_branches * n``, branch-major)
    the padding must not straddle branches: each branch is padded to the
    smallest ``n_pad`` with ``n_branches * n_pad % bn == 0``.
    """
    bm_ = min(DEFAULT_BM, _ceil_mult(m, 8))
    bk_ = DEFAULT_BK if k_dim >= DEFAULT_BK else _ceil_mult(k_dim, 128)
    if nc <= DEFAULT_BN:
        bn_ = nc
        n_pad, nc_pad = n, nc
    elif mode == "nld" and n_branches > 1:
        bn_ = DEFAULT_BN
        n_pad = _ceil_mult(n, bn_ // math.gcd(bn_, n_branches))
        nc_pad = n_branches * n_pad
    else:
        bn_ = DEFAULT_BN
        nc_pad = _ceil_mult(nc, bn_)
        n_pad = nc_pad
    m_pad = _ceil_mult(m, bm_)
    k_pad = _ceil_mult(k_dim, bk_)
    return TilePlan(bm=bm_, bk=bk_, bn=bn_, m_pad=m_pad, k_pad=k_pad,
                    n_pad=n_pad, nc_pad=nc_pad, n_valid=nc,
                    grid=(m_pad // bm_, t, nc_pad // bn_, k_pad // bk_))


class LayerSpec(NamedTuple):
    """Per-layer geometry of the stacked kernel.  ``k_dim`` is the input
    width of this layer's planes (layer 0: the padded event width; deeper
    layers: the previous layer's exact width), ``n`` its columns, ``k`` its
    winners, ``bk`` the K-tile size of the occupancy counters (ragged tail
    allowed).  The reference's column tile does not exist here: the CUDA
    kernel keeps whole rows in registers."""

    k_dim: int
    n: int
    k: int
    bk: int

    @property
    def n_k(self) -> int:
        """Number of K tiles (occupancy words per (step, row tile))."""
        return -(-self.k_dim // self.bk)


# --- ctypes mirrors of the kernels' parameter structs ----------------------

_NOISE_FIELDS = [(name, ctypes.c_float) for name in (
    "offset_lsb", "sigma_lsb", "inl_lsb", "in_lo", "in_span")]


class _Params(ctypes.Structure):
    """Mirror of ``FmskParams`` in ``csrc/fused_macro_seq_kwn.cu``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "msb", "lsb", "bounds", "levels", "scale", "v0", "noise",
        "activity", "row_ctl", "mac", "v_out", "spikes", "mask", "steps",
        "vtrace")] + [
        (name, ctypes.c_int) for name in (
            "t_steps", "m", "k_dim", "n", "n_valid", "k", "n_codes", "bm",
            "bk", "use_snl", "noisy")] + [
        (name, ctypes.c_float) for name in (
            "ratio", "drive_gain", "beta", "v_th1", "v_th2", "v_reset",
            "v_lim", "snl_amp")] + _NOISE_FIELDS


class _NldParams(ctypes.Structure):
    """Mirror of ``FmsnParams`` in ``csrc/fused_macro_seq_nld.cu``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "msb", "lsb", "bounds", "levels", "scale", "w_dend", "v0",
        "activity", "row_ctl", "mac", "v_out", "spikes")] + [
        (name, ctypes.c_int) for name in (
            "t_steps", "m", "k_dim", "n", "n_branches", "logical_n",
            "n_codes", "bm", "bk", "noisy")] + [
        (name, ctypes.c_float) for name in (
            "ratio", "drive_gain", "beta", "v_th1", "v_reset",
            "v_lim")] + _NOISE_FIELDS


MAX_LAYERS = 4          # deepest stack the stacked kernel takes


class _Layer(ctypes.Structure):
    """Mirror of ``FmmkLayer`` in ``csrc/fused_macro_multi_seq_kwn.cu``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "msb", "lsb", "bounds", "levels", "scale", "v0", "noise",
        "v_out")] + [
        (name, ctypes.c_int) for name in ("k_dim", "n", "k", "bk")]


class _MultiParams(ctypes.Structure):
    """Mirror of ``FmmkParams`` in ``csrc/fused_macro_multi_seq_kwn.cu``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "activity", "ctl", "spikes", "mask", "steps", "counts",
        "tile_bits")] + [
        ("layers", _Layer * MAX_LAYERS)] + [
        (name, ctypes.c_int) for name in (
            "n_layers", "t_steps", "m", "bm", "n_codes", "use_snl",
            "noisy")] + [
        (name, ctypes.c_float) for name in (
            "ratio", "drive_gain", "beta", "v_th1", "v_th2", "v_reset",
            "v_lim", "snl_amp")] + _NOISE_FIELDS


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _operand(a, dtype, shape, dev):
    """``a`` itself, after checking that the kernel can take it."""
    if a.device != dev or a.dtype != dtype or not a.is_contiguous() \
            or tuple(a.shape) != tuple(shape):
        raise ValueError(f"kernel operand must be a contiguous {dtype} "
                         f"{tuple(shape)} tensor on {dev}; got "
                         f"{a.dtype} {tuple(a.shape)} on {a.device}")
    return a


def _noise_kw(ima_noise) -> dict:
    nz = ima_noise
    if nz is None:
        return dict(offset_lsb=0.0, sigma_lsb=0.0, inl_lsb=0.0, in_lo=0.0,
                    in_span=1.0)
    # the range denominator is folded in f64 and cast once to f32, as the
    # reference does
    return dict(offset_lsb=nz.offset_lsb, sigma_lsb=nz.sigma_lsb,
                inl_lsb=nz.inl_lsb, in_lo=nz.in_lo,
                in_span=nz.in_hi - nz.in_lo + 1e-9)


def _run(source: str, fn_name: str, params: ctypes.Structure, dev) -> None:
    """Launch ``fn_name`` of ``csrc/<source>.cu`` on the current stream of
    ``dev`` and raise if CUDA refused the launch."""
    fn = getattr(build.library(source), fn_name)
    fn.argtypes = [ctypes.POINTER(type(params)), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.byref(params), stream)
    if err != 0:
        raise RuntimeError(f"{source} launch failed: CUDA error {err}")


def _check_rows(m, bm, k_dim, bk):
    if m % 4 or bm % 4 or k_dim % bk or bk % 32:
        raise ValueError(f"unsupported padding: m={m} bm={bm} "
                         f"k_dim={k_dim} bk={bk}")


def _launch(x, msb, lsb, boundaries, levels, scale, v, noise, activity,
            row_ctl, *, k, ratio, drive_gain, beta, v_th1, v_th2, v_reset,
            v_lim, use_snl, bm, bk, n_valid, ima_noise, snl_amp,
            mac_telemetry, train_trace):
    dev = x.device
    t_steps, m, k_dim = x.shape
    n = msb.shape[1]
    n_codes = levels.shape[0]
    if n > MAX_COLS:
        raise ValueError(f"fused seq-KWN kernel takes at most {MAX_COLS} "
                         f"columns, got {n}")
    _check_rows(m, bm, k_dim, bk)
    f32, i32 = torch.float32, torch.int32
    ops = dict(
        x=_operand(x, torch.int8, (t_steps, m, k_dim), dev),
        msb=_operand(msb, torch.int8, (k_dim, n), dev),
        lsb=_operand(lsb, torch.int8, (k_dim, n), dev),
        bounds=_operand(boundaries, f32, (n_codes - 1,), dev),
        levels=_operand(levels, f32, (n_codes,), dev),
        scale=_operand(scale, f32, (n,), dev),
        v0=_operand(v, f32, (m, n), dev),
        noise=None if noise is None else _operand(noise, f32,
                                                  (t_steps, m, n), dev),
        activity=None if activity is None else _operand(
            activity, i32, (t_steps, m // bm, k_dim // bk), dev),
        row_ctl=_operand(row_ctl, i32, (m, 3), dev))
    outs = dict(
        mac=torch.empty((t_steps, m, n), dtype=f32, device=dev)
        if mac_telemetry else None,
        v_out=torch.empty((m, n), dtype=f32, device=dev),
        spikes=torch.empty((t_steps, m, n), dtype=f32, device=dev),
        mask=torch.empty((t_steps, m, n), dtype=f32, device=dev),
        steps=torch.empty((t_steps, m, 1), dtype=i32, device=dev),
        vtrace=torch.empty((t_steps, m, n), dtype=f32, device=dev)
        if train_trace else None)
    params = _Params(
        **{name: _ptr(a) for name, a in {**ops, **outs}.items()},
        t_steps=t_steps, m=m, k_dim=k_dim, n=n, n_valid=n_valid, k=k,
        n_codes=n_codes, bm=bm, bk=bk, use_snl=int(use_snl),
        noisy=int(ima_noise is not None), ratio=ratio,
        drive_gain=drive_gain, beta=beta, v_th1=v_th1, v_th2=v_th2,
        v_reset=v_reset, v_lim=v_lim, snl_amp=snl_amp,
        **_noise_kw(ima_noise))
    _run("fused_macro_seq_kwn", "fmsk_launch", params, dev)
    fused_macro_seq.launches += 1
    out = (outs["mac"], outs["v_out"], outs["spikes"], outs["mask"],
           outs["steps"])
    return out + (outs["vtrace"],) if train_trace else out


def _default_row_ctl(m, seed, step_offset, dev) -> torch.Tensor:
    """``[seed, step_offset, absolute row]`` per row: the stream of the
    reference's scalar path."""
    rows = torch.arange(m, dtype=torch.int32, device=dev)
    return torch.stack([torch.full_like(rows, int(seed)),
                        torch.full_like(rows, int(step_offset)), rows],
                       dim=-1)


def fused_macro_seq(x, msb, lsb, boundaries, levels, scale, v, noise=None,
                    activity=None, row_ctl=None, *, k: int = 12,
                    ratio: float = 2.0, drive_gain: float = 1.0,
                    beta: float = 0.9, v_th1: float = 1.0,
                    v_th2: float = 0.6, v_reset: float = 0.0,
                    v_lim: float = 8.0, use_snl: bool = True,
                    bm: int = DEFAULT_BM, bk: int = DEFAULT_BK,
                    n_valid: int | None = None, ima_noise=None,
                    snl_amp: float = 0.0, mac_telemetry: bool = True,
                    train_trace: bool = False, seed=0, step_offset=0):
    """A whole fused KWN event sequence in one launch (padded operands).

    x (T, M, K) int8, msb/lsb (K, N) int8, boundaries (n_codes - 1,),
    levels (n_codes,), scale (N,), v (M, N) f32, noise (T, M, N) f32 or
    None (counter streams), activity (T, M/bm, K/bk) int32 or None,
    row_ctl (M, 3) int32 or None.  M is a multiple of ``bm`` and K of
    ``bk``.  Without ``row_ctl`` each row uses ``[seed, step_offset,
    absolute row]``: the stream of the reference's scalar path.

    Returns (mac (T, M, N) or None, v_out (M, N), spikes (T, M, N),
    mask (T, M, N), adc_steps (T, M, 1) int32), and with ``train_trace``
    also vtrace (T, M, N) f32, the saturated membrane before the reset
    (the residual of the surrogate backward).
    """
    m = x.shape[1]
    n = msb.shape[1]
    n_valid = n if n_valid is None else n_valid
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if row_ctl is None:
        row_ctl = _default_row_ctl(m, seed, step_offset, x.device)
    kw = dict(k=k, ratio=ratio, drive_gain=drive_gain, beta=beta,
              v_th1=v_th1, v_th2=v_th2, v_reset=v_reset, v_lim=v_lim,
              use_snl=use_snl, ima_noise=ima_noise, snl_amp=snl_amp,
              mac_telemetry=mac_telemetry, train_trace=train_trace)
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


def _launch_nld(x, msb, lsb, boundaries, levels, scale, w_dend, v,
                activity, row_ctl, *, ratio, drive_gain, beta, v_th1,
                v_reset, v_lim, bm, bk, logical_n, ima_noise,
                mac_telemetry):
    dev = x.device
    t_steps, m, k_dim = x.shape
    n_branches, n = w_dend.shape
    nc = msb.shape[1]
    n_codes = levels.shape[0]
    if nc != n_branches * n:
        raise ValueError(f"NLD planes must have J*N = {n_branches * n} "
                         f"columns, got {nc}")
    if n > MAX_COLS:
        raise ValueError(f"fused seq-NLD kernel takes at most {MAX_COLS} "
                         f"neurons, got {n}")
    _check_rows(m, bm, k_dim, bk)
    f32, i32 = torch.float32, torch.int32
    ops = dict(
        x=_operand(x, torch.int8, (t_steps, m, k_dim), dev),
        msb=_operand(msb, torch.int8, (k_dim, nc), dev),
        lsb=_operand(lsb, torch.int8, (k_dim, nc), dev),
        bounds=_operand(boundaries, f32, (n_codes - 1,), dev),
        levels=_operand(levels, f32, (n_codes,), dev),
        scale=_operand(scale, f32, (nc,), dev),
        w_dend=_operand(w_dend, f32, (n_branches, n), dev),
        v0=_operand(v, f32, (m, n), dev),
        activity=None if activity is None else _operand(
            activity, i32, (t_steps, m // bm, k_dim // bk), dev),
        row_ctl=_operand(row_ctl, i32, (m, 3), dev))
    outs = dict(
        mac=torch.empty((t_steps, m, nc), dtype=f32, device=dev)
        if mac_telemetry else None,
        v_out=torch.empty((m, n), dtype=f32, device=dev),
        spikes=torch.empty((t_steps, m, n), dtype=f32, device=dev))
    params = _NldParams(
        **{name: _ptr(a) for name, a in {**ops, **outs}.items()},
        t_steps=t_steps, m=m, k_dim=k_dim, n=n, n_branches=n_branches,
        logical_n=logical_n, n_codes=n_codes, bm=bm, bk=bk,
        noisy=int(ima_noise is not None), ratio=ratio,
        drive_gain=drive_gain, beta=beta, v_th1=v_th1, v_reset=v_reset,
        v_lim=v_lim, **_noise_kw(ima_noise))
    _run("fused_macro_seq_nld", "fmsn_launch", params, dev)
    fused_macro_seq_nld.launches += 1
    # the NLD head updates every neuron and always runs the full ramp
    mask = torch.ones((t_steps, m, n), dtype=f32, device=dev)
    steps = torch.full((t_steps, m, 1), n_codes - 1, dtype=i32, device=dev)
    return outs["mac"], outs["v_out"], outs["spikes"], mask, steps


def fused_macro_seq_nld(x, msb, lsb, boundaries, levels, scale, w_dend, v,
                        activity=None, row_ctl=None, *, ratio: float = 2.0,
                        drive_gain: float = 1.0, beta: float = 0.9,
                        v_th1: float = 1.0, v_reset: float = 0.0,
                        v_lim: float = 8.0, bm: int = DEFAULT_BM,
                        bk: int = DEFAULT_BK, logical_n: int | None = None,
                        ima_noise=None, mac_telemetry: bool = True,
                        seed=0, step_offset=0):
    """A whole fused NLD event sequence in one launch (padded operands).

    x (T, M, K) int8, msb/lsb (K, J*N) int8 branch-major (column j*N + p
    is branch j of neuron p), scale (J*N,), w_dend (J, N), v (M, N);
    ``logical_n`` is the unpadded per-branch width, the counter noise's
    column basis (a draw lands on ``j * logical_n + p`` whatever the
    padding).  Other operands as ``fused_macro_seq``.

    Returns (mac (T, M, J*N) or None, v_out (M, N), spikes (T, M, N),
    mask (T, M, N) all ones, adc_steps (T, M, 1) all ``n_codes - 1``).
    """
    m = x.shape[1]
    logical_n = w_dend.shape[1] if logical_n is None else logical_n
    if row_ctl is None:
        row_ctl = _default_row_ctl(m, seed, step_offset, x.device)
    kw = dict(ratio=ratio, drive_gain=drive_gain, beta=beta, v_th1=v_th1,
              v_reset=v_reset, v_lim=v_lim, logical_n=logical_n,
              ima_noise=ima_noise, mac_telemetry=mac_telemetry)
    if x.is_cuda:
        return _launch_nld(x, msb, lsb, boundaries, levels, scale, w_dend,
                           v, activity, row_ctl.contiguous(), bm=bm, bk=bk,
                           **kw)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return ref.fused_macro_seq_nld_ref(x, msb, lsb, boundaries, levels,
                                       scale, w_dend, v, row_ctl=row_ctl,
                                       **kw)


fused_macro_seq_nld.launches = 0


def _stack_columns_per_lane(widths) -> int:
    """Register columns per lane the stacked kernel keeps for every layer:
    the widest layer's ``ceil(n / 32)``, rounded up to a power of two."""
    cpl = 1
    while 32 * cpl < max(widths):
        cpl *= 2
    return cpl


def _check_stack(specs, k0):
    """Raise ``ValueError`` for a stack the kernel cannot take."""
    widths = [s.n for s in specs]
    if not 1 <= len(specs) <= MAX_LAYERS:
        raise ValueError(f"the stacked kernel takes 1..{MAX_LAYERS} "
                         f"layers, got {len(specs)}")
    if len(specs) * _stack_columns_per_lane(widths) > 32:
        raise ValueError(
            f"stack widths {widths} need more than the 32 register "
            f"columns per lane the stacked kernel holds (layers x "
            f"ceil(widest / 32), rounded up to a power of two)")
    if k0 % specs[0].bk or specs[0].bk % 32:
        raise ValueError(f"unsupported layer-0 K tiling: k_dim={k0} "
                         f"bk={specs[0].bk}")
    if any(spec.n_k > 32 for spec in specs):
        raise ValueError("the occupancy bits take at most 32 K tiles a "
                         "layer")
    for prev, spec in zip(specs, specs[1:]):
        if spec.k_dim != prev.n:
            raise ValueError(f"layer widths do not chain: {prev} -> {spec}")
        if spec.bk % 32 and spec.bk < spec.k_dim:
            raise ValueError(f"deep-layer K tile {spec.bk} must be a "
                             f"multiple of 32 or cover the layer")


def _launch_multi(x, planes, v0s, noises, activity, ctl, *, specs, ratio,
                  drive_gain, beta, v_th1, v_th2, v_reset, v_lim, use_snl,
                  bm, ima_noise, snl_amp):
    dev = x.device
    t_steps, m, k0 = x.shape
    n_layers = len(specs)
    n_codes = planes[0][3].shape[0]
    f32, i32 = torch.float32, torch.int32
    n_i = m // bm
    layers = (_Layer * MAX_LAYERS)()
    v_outs = []
    for li, (spec, (msb, lsb, bounds, levels, scale)) in enumerate(
            zip(specs, planes)):
        shape = (spec.k_dim, spec.n)
        v_out = torch.empty((m, spec.n), dtype=f32, device=dev)
        v_outs.append(v_out)
        lay = dict(
            msb=_operand(msb, torch.int8, shape, dev),
            lsb=_operand(lsb, torch.int8, shape, dev),
            bounds=_operand(bounds, f32, (n_codes - 1,), dev),
            levels=_operand(levels, f32, (n_codes,), dev),
            scale=_operand(scale, f32, (spec.n,), dev),
            v0=_operand(v0s[li], f32, (m, spec.n), dev),
            noise=None if noises is None else _operand(
                noises[li], f32, (t_steps, m, spec.n), dev),
            v_out=v_out)
        layers[li] = _Layer(**{k: _ptr(a) for k, a in lay.items()},
                            k_dim=spec.k_dim, n=spec.n, k=spec.k,
                            bk=spec.bk)
    n_last = specs[-1].n
    outs = dict(
        spikes=torch.empty((t_steps, m, n_last), dtype=f32, device=dev),
        mask=torch.empty((t_steps, m, n_last), dtype=f32, device=dev),
        steps=torch.empty((n_layers, t_steps, m), dtype=i32, device=dev),
        counts=torch.empty((n_layers, t_steps, m), dtype=f32, device=dev),
        tile_bits=torch.empty((n_layers, t_steps, m), dtype=i32,
                              device=dev))
    ins = dict(
        x=_operand(x, torch.int8, (t_steps, m, k0), dev),
        activity=_operand(activity, i32, (t_steps, n_i, specs[0].n_k), dev),
        ctl=_operand(ctl, i32, (n_layers + 1,), dev))
    params = _MultiParams(
        **{name: _ptr(a) for name, a in {**ins, **outs}.items()},
        layers=layers, n_layers=n_layers, t_steps=t_steps, m=m, bm=bm,
        n_codes=n_codes, use_snl=int(use_snl),
        noisy=int(ima_noise is not None), ratio=ratio,
        drive_gain=drive_gain, beta=beta, v_th1=v_th1, v_th2=v_th2,
        v_reset=v_reset, v_lim=v_lim, snl_amp=snl_amp,
        **_noise_kw(ima_noise))
    _run("fused_macro_multi_seq_kwn", "fmmk_launch", params, dev)
    fused_macro_multi_seq.launches += 1
    # occupied K tiles per (step, row tile): OR the per-row tile bits over
    # the rows of each tile, then count the bits
    occ = []
    for li, spec in enumerate(specs):
        shifts = torch.arange(spec.n_k, dtype=i32, device=dev)
        bits = (outs["tile_bits"][li][..., None] >> shifts) & 1
        occ.append(bits.reshape(t_steps, n_i, bm, spec.n_k).amax(2)
                   .sum(-1).to(i32))
    return (tuple(v_outs), outs["spikes"], outs["mask"], outs["steps"],
            outs["counts"], torch.stack(occ))


def fused_macro_multi_seq(x, planes, v0s, noises, activity, ctl, *,
                          specs: tuple, ratio: float = 2.0,
                          drive_gain: float = 1.0, beta: float = 0.9,
                          v_th1: float = 1.0, v_th2: float = 0.6,
                          v_reset: float = 0.0, v_lim: float = 8.0,
                          use_snl: bool = True, bm: int = DEFAULT_BM,
                          ima_noise=None, snl_amp: float = 0.0):
    """L stacked KWN layers over a whole event sequence in one launch.

    x (T, M, K0) int8 (M a multiple of ``bm``, K0 of layer 0's K tile),
    planes per-layer (msb, lsb, boundaries, levels, scale) with
    (k_dim_l, n_l) planes and ramps of one size, v0s per-layer (M, n_l)
    membranes, noises per-layer (T, M, n_l) SNL noise or None for the
    counter streams,
    activity (T, M/bm, K0/bk0) the layer-0 occupancy map, ctl (L+1,)
    int32: per-layer counter seeds, then the step offset; the counters of
    row i at step t in layer l are ``(ctl[l], ctl[L] + t, i, column)``.

    A stack the kernel cannot hold in registers (``_check_stack``) raises
    ``ValueError`` on every device.

    Returns (v_outs (per layer (M, n_l)), spikes (T, M, n_L) and mask
    (T, M, n_L) of the last layer, steps (L, T, M) int32, counts (L, T, M)
    f32 row spike counts, occupancy (L, T, M/bm) int32 occupied K tiles).
    """
    if x.shape[1] % bm:
        raise ValueError(f"rows {x.shape[1]} are not a multiple of bm={bm}")
    _check_stack(specs, x.shape[2])
    kw = dict(specs=tuple(specs), ratio=ratio, drive_gain=drive_gain,
              beta=beta, v_th1=v_th1, v_th2=v_th2, v_reset=v_reset,
              v_lim=v_lim, use_snl=use_snl, bm=bm, ima_noise=ima_noise,
              snl_amp=snl_amp)
    if x.is_cuda:
        return _launch_multi(x, planes, v0s, noises, activity, ctl, **kw)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return ref.fused_macro_multi_seq_ref(x, planes, v0s, noises, activity,
                                         ctl, **kw)


fused_macro_multi_seq.launches = 0
