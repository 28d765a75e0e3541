"""Public wrappers around the fused kernel: padding, activity planning and
the event-tensor input contract.  Counterpart of ``repro.kernels.ops``
(the KWN sequence path).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch.kernels import fused_macro as _fused


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


def fused_macro_seq(x, msb, lsb, boundaries, levels, scale, v, noise=None, *,
                    k: int = 12, ratio: float = 2.0, drive_gain: float = 1.0,
                    beta: float = 0.9, v_th1: float = 1.0, v_th2: float = 0.6,
                    v_reset: float = 0.0, v_lim: float = 8.0,
                    use_snl: bool = True, ima_noise=None,
                    snl_amp: float = 0.0, activity=None,
                    mac_telemetry: bool = True, seed=0,
                    step_offset=0, row_ctl=None, device=None):
    """Batched time-major fused KWN sequence; x (T, ..., K), v (..., N),
    noise (T, ..., N) or None for the in-kernel counter noise.

    Runs on ``device`` (default ``cuda``; ``"cpu"`` runs the plain
    version).  Pads the batch to the row tile, K to the K tile and a layer
    wider than one macro to whole column tiles (zero padding is
    MAC-neutral; padded columns never win), builds the occupancy map
    (or takes ``activity``) and pads ``row_ctl`` ((..., 3) int32
    per-row ``[seed, step_offset, row_id]``), runs one launch and slices
    the padding back off.

    Returns (mac (T, ..., N) or None, v_out (..., N), spikes (T, ..., N),
    mask (T, ..., N), adc_steps (T, ...)).
    """
    dev = device_lib.resolve(device)
    t = x.shape[0]
    lead = tuple(x.shape[1:-1])
    kdim = x.shape[-1]
    n = v.shape[-1]
    nc = msb.shape[-1]
    if nc != n:
        raise ValueError(f"KWN planes must have N columns: {nc} != {n}")
    xm = torch.as_tensor(x).to(dev).reshape(t, -1, kdim)
    vm = torch.as_tensor(v).to(dev, torch.float32).reshape(-1, n)
    m0 = xm.shape[1]
    plan = _fused.plan_tiles(m0, kdim, nc, n, t)
    xm = F.pad(xm.to(torch.int8), (0, plan.k_pad - kdim, 0, plan.m_pad - m0))
    vm = F.pad(vm, (0, plan.n_pad - n, 0, plan.m_pad - m0))
    if activity is None:
        activity = fused_activity_map(xm, plan)
    else:
        activity = torch.as_tensor(activity).to(dev, torch.int32)
    nm = None
    if noise is not None:
        nm = torch.as_tensor(noise).to(dev, torch.float32).reshape(t, -1, n)
        nm = F.pad(nm, (0, plan.n_pad - n, 0, plan.m_pad - m0))
    pad_planes = (0, plan.n_pad - n, 0, plan.k_pad - kdim)
    msb_p = F.pad(torch.as_tensor(msb).to(dev, torch.int8), pad_planes)
    lsb_p = F.pad(torch.as_tensor(lsb).to(dev, torch.int8), pad_planes)
    scale_p = F.pad(torch.as_tensor(scale).to(dev, torch.float32).reshape(-1),
                    (0, plan.n_pad - n))
    rc = None
    if row_ctl is not None:
        rc = torch.as_tensor(row_ctl).to(dev, torch.int32).reshape(-1, 3)
        rc = F.pad(rc, (0, 0, 0, plan.m_pad - m0))
    mac, v_out, spikes, mask, steps = _fused.fused_macro_seq(
        xm.contiguous(), msb_p.contiguous(), lsb_p.contiguous(),
        torch.as_tensor(boundaries).to(dev, torch.float32).contiguous(),
        torch.as_tensor(levels).to(dev, torch.float32).contiguous(),
        scale_p.contiguous(), vm.contiguous(),
        None if nm is None else nm.contiguous(),
        activity.contiguous(),
        None if rc is None else rc.contiguous(),
        k=k, ratio=ratio, drive_gain=drive_gain, beta=beta, v_th1=v_th1,
        v_th2=v_th2, v_reset=v_reset, v_lim=v_lim, use_snl=use_snl,
        bm=plan.bm, bk=plan.bk, n_valid=plan.n_valid, ima_noise=ima_noise,
        snl_amp=snl_amp, mac_telemetry=mac_telemetry, seed=seed,
        step_offset=step_offset)
    if mac is not None:
        mac = mac[:, :m0, :n].reshape(t, *lead, nc)
    return (mac,
            v_out[:m0, :n].reshape(*lead, n),
            spikes[:, :m0, :n].reshape(t, *lead, n),
            mask[:, :m0, :n].reshape(t, *lead, n),
            steps[:, :m0, 0].reshape(t, *lead))
