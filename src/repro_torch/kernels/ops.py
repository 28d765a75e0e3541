"""Public wrappers around the kernels: padding, activity planning and the
event-tensor input contract.  Counterpart of ``repro.kernels.ops``: the
composed chain's single-stage kernels (``ternary_mac``, ``nlq_convert``,
``kwn_topk``, ``lif_step``) and the fused sequence paths (single-layer KWN
and NLD, their per-step form, the KWN stack, and the differentiable KWN
sequence of silicon training).

Every wrapper runs on ``device`` (default ``cuda``; ``"cpu"`` runs the
plain versions) and takes leading batch dimensions as the reference does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch.core import ternary as ternary_lib
from repro_torch.kernels import fused_macro as _fused
from repro_torch.kernels import fused_macro_grad as _fused_grad
from repro_torch.kernels import kwn_topk as _kwn
from repro_torch.kernels import lif_step as _lif
from repro_torch.kernels import nlq_lut as _nlq
from repro_torch.kernels import ternary_mac as _tmac


# --- the composed chain: one kernel a stage -----------------------------------

def _rows(a, dev, dtype) -> torch.Tensor:
    """``a`` on ``dev`` as a contiguous (rows, last) ``dtype`` matrix (the
    rows counted, so that an empty last axis, K = 0, keeps them)."""
    a = torch.as_tensor(a).to(dev, dtype)
    return a.reshape(math.prod(a.shape[:-1]), a.shape[-1]).contiguous()


def ternary_mac(x, msb, lsb, ratio: float = 2.0, device=None) -> torch.Tensor:
    """Twin-cell ternary MAC: x (..., K) ternary, msb / lsb (K, N) ternary
    planes -> (..., N) f32 ``x @ (ratio * msb + lsb)``.  The kernel masks
    ragged shapes itself: nothing is padded."""
    dev = device_lib.resolve(device)
    lead = tuple(x.shape[:-1])
    out = _tmac.ternary_mac(_rows(x, dev, torch.int8),
                            _rows(msb, dev, torch.int8),
                            _rows(lsb, dev, torch.int8), ratio=ratio)
    return out.reshape(*lead, out.shape[-1])


def nlq_convert(x, boundaries, levels, device=None):
    """NLQ ramp conversion and LUT map-back: x (..., N) -> (codes (..., N)
    int32, reconstruction (..., N) f32)."""
    dev = device_lib.resolve(device)
    f32 = torch.float32
    codes, y = _nlq.nlq_convert(
        _rows(x, dev, f32), torch.as_tensor(boundaries).to(dev, f32)
        .contiguous(), torch.as_tensor(levels).to(dev, f32).contiguous())
    return codes.reshape(x.shape), y.reshape(x.shape)


def kwn_topk(mac, boundaries, k: int, device=None):
    """KWN top-K with ramp early stop: mac (..., N) -> (mask (..., N) f32,
    adc_steps (...,) int32)."""
    dev = device_lib.resolve(device)
    mask, steps = _kwn.kwn_topk(
        _rows(mac, dev, torch.float32),
        torch.as_tensor(boundaries).to(dev, torch.float32).contiguous(), k)
    return mask.reshape(mac.shape), steps[:, 0].reshape(mac.shape[:-1])


def lif_step(v, drive, mask, noise, device=None, **params):
    """The fused LIF step: v, drive, mask, noise all (..., N) -> (v_out,
    spikes), both (..., N) f32; ``params`` are ``lif_step_fused``'s
    (beta, v_th1, v_th2, v_reset, v_lim, use_snl)."""
    dev = device_lib.resolve(device)
    flat = [_rows(a, dev, torch.float32) for a in (v, drive, mask, noise)]
    v_out, spikes = _lif.lif_step_fused(*flat, **params)
    return v_out.reshape(v.shape), spikes.reshape(v.shape)


# --- the fused sequence paths ---------------------------------------------------


def event_stream_issues(events, n_in: int | None = None):
    """Host-side check of the fused kernels' event-tensor input contract.

    The kernels consume a ``(T, n_in)`` ternary tensor: finite values in
    {-1, 0, +1}, a real-number dtype, at least one time step.  Pure numpy.
    Returns ``(ev, issues)``: the ``np.ndarray`` view of ``events`` (or
    None when it cannot be materialized) and a list of ``(code, message)``
    pairs with codes ``dtype`` / ``shape`` / ``empty`` / ``nonfinite`` /
    ``nonternary``; an empty list means the tensor is launchable as-is.
    """
    issues: list[tuple[str, str]] = []
    if isinstance(events, torch.Tensor):
        events = events.detach().cpu().numpy()
    try:
        ev = np.asarray(events)
    except Exception as e:   # ragged lists, arbitrary objects
        return None, [("dtype", f"events not array-like ({e})")]
    if ev.dtype == object or ev.dtype.kind in "USVcM":
        return ev, [("dtype", f"events dtype {ev.dtype} is not a real "
                              f"number type")]
    if ev.ndim != 2:
        issues.append(("shape", f"events must be (T, n_in); got shape "
                                f"{ev.shape}"))
    elif n_in is not None and ev.shape[1] != n_in:
        issues.append(("shape", f"events width {ev.shape[1]} != engine "
                                f"n_in {n_in}"))
    if ev.size == 0:
        issues.append(("empty", f"zero-length event stream (shape "
                                f"{ev.shape})"))
        return ev, issues
    if ev.dtype.kind == "f" and not bool(np.isfinite(ev).all()):
        issues.append(("nonfinite", "events carry NaN/Inf values"))
        return ev, issues     # ternary test on NaNs would double-report
    if not bool(np.isin(ev, (-1.0, 0.0, 1.0)).all()):
        bad = ev[~np.isin(ev, (-1.0, 0.0, 1.0))]
        issues.append(("nonternary",
                       f"events must be ternary in {{-1, 0, +1}}; got "
                       f"{bad.flat[0]!r} (and {bad.size - 1} more)"))
    return ev, issues


def fused_activity_map(xm: torch.Tensor, plan) -> torch.Tensor:
    """Per-(step, row-tile, K-tile) occupancy of a padded time-major input:
    (T, m_pad/bm, k_pad/bk) int32, 1 where the block holds an event."""
    t = xm.shape[0]
    n_i, n_k = plan.m_pad // plan.bm, plan.k_pad // plan.bk
    occ = (xm != 0).reshape(t, n_i, plan.bm, n_k, plan.bk)
    return occ.any(dim=4).any(dim=2).to(torch.int32)


def _pad_cols(a: torch.Tensor, n: int, n_pad: int,
              n_branches: int) -> torch.Tensor:
    """Zero-pad the branch-major column axis (last) from J*n to J*n_pad."""
    if n_pad == n:
        return a
    lead = a.shape[:-1]
    branched = a.reshape(*lead, n_branches, n)
    return F.pad(branched, (0, n_pad - n)).reshape(*lead, n_branches * n_pad)


def _unpad_cols(a: torch.Tensor, n: int, n_pad: int,
                n_branches: int) -> torch.Tensor:
    """Inverse of ``_pad_cols`` for branch-major column outputs."""
    if n_pad == n:
        return a
    lead = a.shape[:-1]
    branched = a.reshape(*lead, n_branches, n_pad)
    return branched[..., :n].reshape(*lead, n_branches * n)


def fused_macro_seq(x, msb, lsb, boundaries, levels, scale, v, noise=None,
                    w_dend=None, *, mode: str = "kwn", k: int = 12,
                    ratio: float = 2.0, drive_gain: float = 1.0,
                    beta: float = 0.9, v_th1: float = 1.0, v_th2: float = 0.6,
                    v_reset: float = 0.0, v_lim: float = 8.0,
                    use_snl: bool = True, bm: int | None = None,
                    bk: int | None = None, bn: int | None = None,
                    ima_noise=None, snl_amp: float = 0.0,
                    gate: bool = True, activity=None,
                    mac_telemetry: bool = True, train_trace: bool = False,
                    seed=0, step_offset=0, row_ctl=None, device=None):
    """Batched time-major fused sequence; x (T, ..., K), v (..., N),
    noise (T, ..., N) or None for the in-kernel counter noise.

    ``mode="kwn"``: N columns, the KWN head with SNL.  ``mode="nld"``:
    branch-major J*N columns, ``w_dend`` (J, N), the NLD head (no SNL, so
    ``noise``, ``k``, ``v_th2``, ``use_snl`` and ``snl_amp`` are unused).

    Runs on ``device`` (default ``cuda``; ``"cpu"`` runs the plain
    version).  Plans through ``fused_macro.plan_tiles`` on that device
    (``bm`` / ``bk`` / ``bn`` pin the blocks and bypass the plan cache;
    a plan the kernels cannot take raises ``ValueError`` before any
    launch).  Pads the batch to the row tile, K to the K tile and a layer
    wider than one macro to whole column tiles (zero padding is
    MAC-neutral; padded KWN columns never win; NLD pads each branch, so
    the branch-major layout survives), builds the occupancy map (or takes
    ``activity``) and pads ``row_ctl`` ((..., 3) int32 per-row ``[seed,
    step_offset, row_id]``), runs one launch and slices the padding back
    off.  The counter noise is keyed on logical columns, so padding never
    moves a draw, and no plan moves an output bit.  ``gate=False`` hands
    the kernel no occupancy map: its dense path, the reference's
    baseline.

    ``train_trace`` (KWN only) also returns vtrace (T, ..., N), the
    saturated membrane before the reset: the residual of the surrogate
    backward.

    Returns (mac (T, ..., NC) or None, v_out (..., N), spikes (T, ..., N),
    mask (T, ..., N), adc_steps (T, ...)), plus vtrace with ``train_trace``.
    """
    dev = device_lib.resolve(device)
    if train_trace and mode != "kwn":
        raise ValueError("train_trace is KWN-only (silicon training)")
    t = x.shape[0]
    lead = tuple(x.shape[1:-1])
    kdim = x.shape[-1]
    n = v.shape[-1]
    nc = msb.shape[-1]
    if mode == "nld":
        if w_dend is None or nc % n:
            raise ValueError(f"NLD needs w_dend and J*N columns: nc={nc} "
                             f"n={n}")
        n_branches = nc // n
    elif mode == "kwn":
        if nc != n:
            raise ValueError(f"KWN planes must have N columns: {nc} != {n}")
        n_branches = 1
    else:
        raise ValueError(f"unknown mode {mode!r}")
    xm = torch.as_tensor(x).to(dev).reshape(t, -1, kdim)
    vm = torch.as_tensor(v).to(dev, torch.float32).reshape(-1, n)
    m0 = xm.shape[1]
    plan = _fused.plan_tiles(m0, kdim, nc, n, t, mode=mode,
                             n_branches=n_branches, bm=bm, bk=bk, bn=bn,
                             device=dev)
    _fused.check_plan(plan)
    xm = F.pad(xm.to(torch.int8), (0, plan.k_pad - kdim, 0, plan.m_pad - m0))
    vm = F.pad(vm, (0, plan.n_pad - n, 0, plan.m_pad - m0))
    if not gate:
        activity = None
    elif activity is None:
        activity = fused_activity_map(xm, plan).contiguous()
    else:
        activity = torch.as_tensor(activity).to(dev, torch.int32) \
            .contiguous()
    pad_k = (0, 0, 0, plan.k_pad - kdim)
    msb_p, lsb_p = (
        _pad_cols(F.pad(torch.as_tensor(a).to(dev, torch.int8), pad_k), n,
                  plan.n_pad, n_branches).contiguous() for a in (msb, lsb))
    scale_p = _pad_cols(
        torch.as_tensor(scale).to(dev, torch.float32).reshape(-1), n,
        plan.n_pad, n_branches).contiguous()
    rc = None
    if row_ctl is not None:
        rc = torch.as_tensor(row_ctl).to(dev, torch.int32).reshape(-1, 3)
        rc = F.pad(rc, (0, 0, 0, plan.m_pad - m0)).contiguous()
    bounds = torch.as_tensor(boundaries).to(dev, torch.float32).contiguous()
    lut = torch.as_tensor(levels).to(dev, torch.float32).contiguous()
    if mode == "nld":
        w_dend_p = F.pad(torch.as_tensor(w_dend).to(dev, torch.float32),
                         (0, plan.n_pad - n))
        mac, v_out, spikes, mask, steps = _fused.fused_macro_seq(
            xm.contiguous(), msb_p, lsb_p, bounds, lut, scale_p,
            vm.contiguous(), None, w_dend_p.contiguous(), activity, rc,
            mode="nld", ratio=ratio, drive_gain=drive_gain, beta=beta,
            v_th1=v_th1, v_reset=v_reset, v_lim=v_lim, bm=plan.bm,
            bk=plan.bk, logical_n=n, ima_noise=ima_noise,
            mac_telemetry=mac_telemetry, seed=seed, step_offset=step_offset)
        if mac is not None:
            mac = _unpad_cols(mac[:, :m0], n, plan.n_pad, n_branches)
            mac = mac.reshape(t, *lead, nc)
        return (mac,
                v_out[:m0, :n].reshape(*lead, n),
                spikes[:, :m0, :n].reshape(t, *lead, n),
                mask[:, :m0, :n].reshape(t, *lead, n),
                steps[:, :m0, 0].reshape(t, *lead))
    nm = None
    if noise is not None:
        nm = torch.as_tensor(noise).to(dev, torch.float32).reshape(t, -1, n)
        nm = F.pad(nm, (0, plan.n_pad - n, 0, plan.m_pad - m0))
    outs = _fused.fused_macro_seq(
        xm.contiguous(), msb_p, lsb_p, bounds, lut, scale_p,
        vm.contiguous(), None if nm is None else nm.contiguous(),
        activity=activity, row_ctl=rc, k=k, ratio=ratio,
        drive_gain=drive_gain, beta=beta, v_th1=v_th1, v_th2=v_th2,
        v_reset=v_reset, v_lim=v_lim, use_snl=use_snl,
        bm=plan.bm, bk=plan.bk, n_valid=plan.n_valid, ima_noise=ima_noise,
        snl_amp=snl_amp, mac_telemetry=mac_telemetry,
        train_trace=train_trace, seed=seed, step_offset=step_offset)
    mac, v_out, spikes, mask, steps = outs[:5]
    if mac is not None:
        mac = mac[:, :m0, :n].reshape(t, *lead, nc)
    ret = (mac,
           v_out[:m0, :n].reshape(*lead, n),
           spikes[:, :m0, :n].reshape(t, *lead, n),
           mask[:, :m0, :n].reshape(t, *lead, n),
           steps[:, :m0, 0].reshape(t, *lead))
    if train_trace:
        ret += (outs[5][:, :m0, :n].reshape(t, *lead, n),)
    return ret


def fused_macro_step(x, msb, lsb, boundaries, levels, scale, v, noise=None,
                     w_dend=None, *, mode: str = "kwn", k: int = 12,
                     ratio: float = 2.0, drive_gain: float = 1.0,
                     beta: float = 0.9, v_th1: float = 1.0,
                     v_th2: float = 0.6, v_reset: float = 0.0,
                     v_lim: float = 8.0, use_snl: bool = True,
                     bm: int | None = None, bk: int | None = None,
                     bn: int | None = None, ima_noise=None,
                     snl_amp: float = 0.0, gate: bool = True,
                     mac_telemetry: bool = True, seed=0, step_offset=0,
                     device=None):
    """One time step: the T=1 case of ``fused_macro_seq`` (one launch),
    with its plan overrides and ``gate``.

    x (..., K), v (..., N), noise (..., N) or None.  With counter noise,
    pass the step index as ``step_offset`` so that a per-step loop draws
    the stream of the one-launch sequence.  Returns (mac (..., NC) or None,
    v_out (..., N), spikes (..., N), mask (..., N), adc_steps (...)).
    """
    mac, v_out, spikes, mask, steps = fused_macro_seq(
        x[None], msb, lsb, boundaries, levels, scale, v,
        None if noise is None else noise[None], w_dend, mode=mode, k=k,
        ratio=ratio, drive_gain=drive_gain, beta=beta, v_th1=v_th1,
        v_th2=v_th2, v_reset=v_reset, v_lim=v_lim, use_snl=use_snl, bm=bm,
        bk=bk, bn=bn, ima_noise=ima_noise, snl_amp=snl_amp, gate=gate,
        mac_telemetry=mac_telemetry, seed=seed, step_offset=step_offset,
        device=device)
    return (None if mac is None else mac[0], v_out, spikes[0], mask[0],
            steps[0])


class MultiSeqOut(NamedTuple):
    """Outputs of the stacked sequence.  ``spikes`` / ``mask`` are the last
    layer's; hidden layers surface only as telemetry: ``spike_counts``
    (per layer (T, ...) row spike totals, for the SOP accounting) and
    ``occupancy`` (per layer (T, row tiles) occupied K tiles), with
    ``total_blocks`` the skipped-block ratio's denominator over all
    layers."""

    v_outs: tuple
    spikes: torch.Tensor
    mask: torch.Tensor
    steps: tuple
    spike_counts: tuple
    occupancy: tuple
    total_blocks: int


def stack_operands(x, stack, vs, noises=None, *, ks, seeds=None,
                   step_offset=0, bm: int | None = None, tile_shapes=None,
                   gate: bool = True, device=None):
    """The padded operands of one stacked launch on ``device``: (x (T,
    m_pad, k_pad) int8, per-layer planes, membranes and noises, the
    layer-0 occupancy map (None without ``gate``), ``ctl`` (L+1,) int32,
    the ``LayerSpec``s, layer 0's ``TilePlan``).

    Layer 0 plans through ``plan_tiles`` (``bm`` and ``tile_shapes[0]``'s
    K tile pin it) and is the only one padded (rows to the row tile, K to
    its K tile).  Deeper layers keep their exact widths; their K tile is
    ``tile_shapes[l]``'s, else that of a tuned single-layer plan for
    their shape capped to the layer, else ``min(k_dim, 256)``.
    ``tile_shapes`` holds the reference's per-layer (bk, bn): the kernel
    has no column tile, so bn is not read."""
    dev = device_lib.resolve(device)
    t = x.shape[0]
    kdim = x.shape[-1]
    n_layers = len(stack)
    widths = [int(s[0].shape[-1]) for s in stack]
    if len(ks) != n_layers:
        raise ValueError(f"{len(ks)} winner counts for {n_layers} layers")
    if tile_shapes is None:
        tile_shapes = [(None, None)] * n_layers
    xm = torch.as_tensor(x).to(dev).reshape(t, -1, kdim)
    m0 = xm.shape[1]
    plan0 = _fused.plan_tiles(m0, kdim, widths[0], widths[0], t, bm=bm,
                              bk=tile_shapes[0][0], device=dev)
    _fused.check_plan(plan0)
    xm = F.pad(xm.to(torch.int8),
               (0, plan0.k_pad - kdim, 0, plan0.m_pad - m0)).contiguous()
    activity = fused_activity_map(xm, plan0).contiguous() if gate else None
    specs = []
    for li in range(n_layers):
        k_dim = plan0.k_pad if li == 0 else widths[li - 1]
        bk_l, bn_l = tile_shapes[li]
        if li == 0:
            bk_l = plan0.bk               # the host occupancy map's
        elif bk_l is None and bn_l is None:
            cb = _fused.cached_plan_blocks(m0, k_dim, widths[li], widths[li],
                                           t, mode="kwn", device=dev)
            if cb is not None:
                bk_l = min(cb.bk, k_dim)
        specs.append(_fused.LayerSpec(
            k_dim=k_dim, n=widths[li], k=int(ks[li]),
            bk=int(bk_l or min(k_dim, _fused.DEFAULT_BK))))
    pad_m = (0, 0, 0, plan0.m_pad - m0)
    vs_p = [F.pad(torch.as_tensor(v).to(dev, torch.float32).reshape(-1, w),
                  pad_m).contiguous() for v, w in zip(vs, widths)]
    noises_p = None
    if noises is not None:
        noises_p = [F.pad(torch.as_tensor(nz).to(dev, torch.float32)
                          .reshape(t, -1, w), pad_m).contiguous()
                    for nz, w in zip(noises, widths)]
    seeds = [0] * n_layers if seeds is None else [int(s) for s in seeds]
    ctl = torch.tensor(seeds + [int(step_offset)], dtype=torch.int32,
                       device=dev)
    planes = []
    for li, (msb, lsb, bounds, levels, scale) in enumerate(stack):
        pad_k = (0, 0, 0, plan0.k_pad - kdim) if li == 0 else (0, 0, 0, 0)
        planes.append(tuple(
            [F.pad(torch.as_tensor(a).to(dev, torch.int8), pad_k)
             .contiguous() for a in (msb, lsb)]
            + [torch.as_tensor(a).to(dev, torch.float32).reshape(-1)
               .contiguous() for a in (bounds, levels, scale)]))
    return xm, planes, vs_p, noises_p, activity, ctl, tuple(specs), plan0


def fused_macro_multi_seq(x, stack, vs, noises=None, *, ks,
                          ratio: float = 2.0, drive_gain: float = 1.0,
                          beta: float = 0.9, v_th1: float = 1.0,
                          v_th2: float = 0.6, v_reset: float = 0.0,
                          v_lim: float = 8.0, use_snl: bool = True,
                          bm: int | None = None, tile_shapes=None,
                          ima_noise=None, snl_amp: float = 0.0,
                          gate: bool = True, seeds=None, step_offset=0,
                          device=None) -> MultiSeqOut:
    """L stacked KWN layers, batched: x (T, ..., K0), one launch.

    stack: per-layer (msb, lsb, boundaries, levels, scale) with
    (k_dim_l, n_l) planes, k_dim_l == n_{l-1} for l > 0; vs per-layer
    (..., n_l) membranes; noises per-layer (T, ..., n_l) or None for the
    counter streams; ks per-layer winner counts; seeds per-layer counter
    seeds (zeros when None).

    The operands are padded by ``stack_operands`` (which reads ``bm``
    and ``tile_shapes``) and the padding is sliced back off.  Layer 0
    gates on the host occupancy map, deeper layers on the previous
    layer's spikes; ``gate=False`` hands the kernel no map (layer 0
    dense) and reports every K tile of every layer occupied, as the
    reference's dense kernel does.
    """
    dev = device_lib.resolve(device)
    t = x.shape[0]
    lead = tuple(x.shape[1:-1])
    widths = [int(s[0].shape[-1]) for s in stack]
    xm, planes, vs_p, noises_p, activity, ctl, specs, plan0 = \
        stack_operands(x, stack, vs, noises, ks=ks, seeds=seeds,
                       step_offset=step_offset, bm=bm,
                       tile_shapes=tile_shapes, gate=gate, device=dev)
    m0 = int(np.prod(lead, dtype=np.int64))
    v_outs, spikes, mask, steps, counts, occ = _fused.fused_macro_multi_seq(
        xm, planes, vs_p, noises_p, activity, ctl, specs=specs,
        ratio=ratio, drive_gain=drive_gain, beta=beta, v_th1=v_th1,
        v_th2=v_th2, v_reset=v_reset, v_lim=v_lim, use_snl=use_snl,
        bm=plan0.bm, ima_noise=ima_noise, snl_amp=snl_amp)
    n_i = plan0.m_pad // plan0.bm
    return MultiSeqOut(
        v_outs=tuple(v[:m0].reshape(*lead, w)
                     for v, w in zip(v_outs, widths)),
        spikes=spikes[:, :m0].reshape(t, *lead, widths[-1]),
        mask=mask[:, :m0].reshape(t, *lead, widths[-1]),
        steps=tuple(s[:, :m0].reshape(t, *lead) for s in steps),
        spike_counts=tuple(c[:, :m0].reshape(t, *lead) for c in counts),
        occupancy=tuple(occ),
        total_blocks=t * n_i * sum(spec.n_k for spec in specs))


# --- the differentiable sequence: silicon-in-the-loop training --------------

class SeqVJPSpec(NamedTuple):
    """Static configuration of ``fused_macro_seq_vjp``: the forward's
    keywords plus the surrogate backward's: ``kwn_relax`` (the loser
    gradient leak through the hard winner gate), ``surrogate_beta``
    (SuperSpike sharpness), ``ste_lo`` / ``ste_hi`` (the ramp's
    straight-through window, in integer MAC units), ``remat`` (recompute
    the MAC in the backward instead of keeping the (T, M, N) residual: the
    same bits), ``gate`` (hand the forward its occupancy map and the
    backward the row-tile map: the same bits) and ``bm`` / ``bk`` / ``bn``
    (pin the tile plan of both; None plans through ``plan_tiles``)."""

    k: int = 12
    ratio: float = 2.0
    drive_gain: float = 1.0
    beta: float = 0.9
    v_th1: float = 1.0
    v_th2: float = 0.6
    v_reset: float = 0.0
    v_lim: float = 8.0
    use_snl: bool = True
    ima_noise: object = None          # ima.IMAKernelNoise | None
    snl_amp: float = 0.0
    kwn_relax: float = 0.0
    surrogate_beta: float = 4.0
    ste_lo: float = -24.5
    ste_hi: float = 24.5
    remat: bool = False
    gate: bool = True
    bm: int | None = None
    bk: int | None = None
    bn: int | None = None


class _SeqVJP(torch.autograd.Function):
    """Forward: the seq-KWN kernel with its training trace.  Backward: the
    surrogate backward kernel, on the forward's tile plan: the plan is
    resolved once, and both sides launch with its blocks pinned, so a
    plan cache cannot give them different plans."""

    @staticmethod
    def forward(ctx, spec: SeqVJPSpec, w, x, boundaries, levels, scale, v,
                noise, seed: int):
        kdim, n = w.shape
        plan = _fused.plan_tiles(
            int(np.prod(x.shape[1:-1], dtype=np.int64)), kdim, n, n,
            x.shape[0], bm=spec.bm, bk=spec.bk, bn=spec.bn, device=x.device)
        blocks = dict(bm=plan.bm, bk=plan.bk, bn=plan.bn)
        msb, lsb = ternary_lib.weight_decompose(w.detach())
        mac, v_out, spikes, mask, _, vtrace = fused_macro_seq(
            x, ternary_lib.pack_ternary(msb), ternary_lib.pack_ternary(lsb),
            boundaries, levels, scale, v, noise, mode="kwn", k=spec.k,
            ratio=spec.ratio, drive_gain=spec.drive_gain, beta=spec.beta,
            v_th1=spec.v_th1, v_th2=spec.v_th2, v_reset=spec.v_reset,
            v_lim=spec.v_lim, use_snl=spec.use_snl,
            ima_noise=spec.ima_noise, snl_amp=spec.snl_amp, gate=spec.gate,
            mac_telemetry=not spec.remat, train_trace=True, seed=seed,
            device=x.device, **blocks)
        ctx.spec = spec
        ctx.blocks = blocks
        ctx.save_for_backward(w.detach(), x, scale, mask, vtrace, mac)
        return spikes, v_out

    @staticmethod
    def backward(ctx, g_spk, g_vout):
        spec = ctx.spec
        w, x, scale, mask, vtrace, mac = ctx.saved_tensors
        args = seq_grad_operands(x, w, scale, mask, vtrace, mac, g_spk,
                                 g_vout, remat=spec.remat, gate=spec.gate,
                                 **ctx.blocks)
        dw_p, dv0_p = _fused_grad.fused_macro_seq_grad(
            *args, ratio=spec.ratio, drive_gain=spec.drive_gain,
            beta=spec.beta, v_th1=spec.v_th1, v_lim=spec.v_lim,
            kwn_relax=spec.kwn_relax, surrogate_beta=spec.surrogate_beta,
            ste_lo=spec.ste_lo, ste_hi=spec.ste_hi)
        kdim, n = w.shape
        m0 = int(np.prod(x.shape[1:-1], dtype=np.int64))
        dv0 = dv0_p[:m0, :n].reshape(*x.shape[1:-1], n)
        return None, dw_p[:kdim, :n], None, None, None, None, dv0, None, None


def seq_grad_operands(x, w, scale, mask, vtrace, mac, g_spk, g_vout, *,
                      remat: bool, gate: bool, bm: int | None = None,
                      bk: int | None = None, bn: int | None = None) -> tuple:
    """The operands of the backward kernel, padded to the forward's tile
    plan (``bm`` / ``bk`` / ``bn`` as the forward launched; None plans
    through ``plan_tiles`` on ``x``'s device): (x, scale, g_spk, g_vfin,
    vtrace, mask, mac, msb, lsb, activity), positional for
    ``fused_macro_grad.fused_macro_seq_grad``.

    x (T, ..., K) the forward's events, w (K, N) its weight in integer
    MAC units (planes for ``remat``), mask / vtrace / g_spk (T, ..., N),
    mac (T, ..., N) the MAC residual (unused with ``remat``), g_vout
    (..., N).  With ``gate`` the row-tile activity map (any K tile
    occupied) goes with them.
    """
    t = x.shape[0]
    kdim, n = w.shape
    xm = x.reshape(t, -1, kdim)
    m0 = xm.shape[1]
    plan = _fused.plan_tiles(m0, kdim, n, n, t, bm=bm, bk=bk, bn=bn,
                             device=x.device)
    _fused.check_plan(plan)
    xm = F.pad(xm.to(torch.int8),
               (0, plan.k_pad - kdim, 0, plan.m_pad - m0)).contiguous()
    pad_n = (0, plan.n_pad - n, 0, plan.m_pad - m0)

    def stack(a):
        return F.pad(a.reshape(t, m0, n).float(), pad_n).contiguous()

    activity = None
    if gate:
        activity = fused_activity_map(xm, plan).amax(2).contiguous()
    msb = lsb = mac_p = None
    if remat:
        pad_kn = (0, plan.n_pad - n, 0, plan.k_pad - kdim)
        msb, lsb = (ternary_lib.pack_ternary(F.pad(a, pad_kn)).contiguous()
                    for a in ternary_lib.weight_decompose(w.detach()))
    else:
        mac_p = stack(mac)
    scale_p = F.pad(scale.reshape(-1).float(), (0, plan.n_pad - n))
    return (xm, scale_p.contiguous(), stack(g_spk),
            F.pad(g_vout.reshape(m0, n).float(), pad_n).contiguous(),
            stack(vtrace), stack(mask), mac_p, msb, lsb, activity)


def fused_macro_seq_vjp(spec: SeqVJPSpec, w, x, boundaries, levels, scale,
                        v, noise=None, seed: int = 0):
    """``fused_macro_seq`` (KWN) with a surrogate backward, on ``x``'s
    device.

    w (K, N) f32 weight in integer MAC units (rounded onto the twin-cell
    grid in the value, straight through in the gradient), x (T, ..., K)
    ternary events (no gradient), v (..., N) initial membrane, noise
    (T, ..., N) streamed SNL noise, or None for the counter SNL stream
    (or none without SNL), seed the counter-PRNG seed word.  The forward
    is the serving kernel with its training trace, the backward the
    surrogate backward kernel, whose gradients are those of
    ``kernels.ref.fused_macro_seq_vjp_ref``.  On a CUDA tensor both launch
    their kernels; on a CPU tensor both run their plain versions.

    Returns (spikes (T, ..., N), v_out (..., N)), both differentiable in
    ``w`` and ``v``.
    """
    return _SeqVJP.apply(spec, w, x, boundaries, levels, scale, v, noise,
                         int(seed))
