"""Plain PyTorch versions of the fused macro kernels.

Counterparts of ``repro.kernels.ref``: ``fused_macro_seq_ref`` (KWN mode,
``fused_head_ref`` / ``fused_macro_step_ref`` folded left over T, with
``counter_snl_noise`` for the in-kernel SNL stream),
``fused_macro_seq_nld_ref`` (the NLD head) and
``fused_macro_multi_seq_ref`` (the KWN stack, layer by layer).  Each is
the function its wrapper in ``kernels.fused_macro`` computes for a CPU
tensor, and the yardstick its CUDA kernel is held against on the card; it
is never a fallback for a CUDA tensor.

Beyond the JAX oracle it takes ``row_ctl`` ((M, 3) int32
``[seed, step_offset, row_id]`` per row, replacing the scalar seed/step
and the absolute row of the noise counters) and ``n_valid`` (columns at
and past it are padding: they take code -1 and never win), so that it
covers every operand the kernel accepts.

Bitwise parity with the reference: MAC partials are small integers (exact
in f32 in any order), KWN is compare/select, and the places where rounding
matters use the reference's arithmetic: the LIF update ``beta * v +
drive`` is one fused multiply-add, the NLD soma sum over branches is a
chain of fused multiply-adds in branch order (XLA contracts
``sum(act * w_dend)`` that way), and the noise path runs through
``core.ctrprng`` / ``core.f32math``.
"""

from __future__ import annotations

import torch

from repro_torch.core import ctrprng, f32math


def ramp_codes(mac: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """Ramp conversion: code = number of boundaries strictly below."""
    return (mac[..., None] > boundaries).sum(-1).to(torch.int32)


def kwn_select(codes: torch.Tensor, k: int, n_codes: int):
    """Descending-ramp priority-encoded top-K on a (M, N) code plane.

    Columns win in order of descending code, ties in index order; code -1
    (padding) never wins.  ``steps`` is ``n_codes - 1 - code`` of the K-th
    winner, or ``n_codes - 1`` when fewer than K columns can win.  Returns
    (mask f32 (M, N), steps int32 (M, 1)).
    """
    m, n = codes.shape
    kk = min(k, n)
    idx = torch.arange(n, device=codes.device, dtype=torch.int64)
    key = codes.to(torch.int64) * n + (n - 1 - idx)
    top_key, top_idx = torch.topk(key, kk, dim=-1)
    top_code = torch.div(top_key, n, rounding_mode="floor")
    valid = top_code >= 0
    mask = torch.zeros((m, n), dtype=torch.float32, device=codes.device)
    mask.scatter_(1, top_idx, valid.float())
    reached = valid.sum(-1) >= k
    kth = top_code[:, -1]
    steps = torch.where(reached, n_codes - 1 - kth,
                        torch.full_like(kth, n_codes - 1))
    return mask, steps.to(torch.int32)[:, None]


def lif_update(v, drive, mask, noise, *, beta, v_th1, v_th2, v_reset, v_lim,
               use_snl):
    """Eq. (1): winners leak and integrate (one fused multiply-add), the
    rest hold; SNL kick in (v_th2, v_th1); saturate; compare; reset."""
    v_new = torch.where(mask > 0, f32math.fma(beta, v, drive), v)
    if use_snl:
        snl = (v_new > v_th2) & (v_new < v_th1)
        v_new = torch.where(snl, v_new + noise, v_new)
    v_new = torch.clamp(v_new, -v_lim, v_lim)
    spike = (v_new >= v_th1).float()
    return torch.where(spike > 0, torch.full_like(v_new, v_reset), v_new), spike


def fused_macro_seq_ref(x, msb, lsb, boundaries, levels, scale, v,
                        noise=None, *, row_ctl, k: int = 12,
                        ratio: float = 2.0, drive_gain: float = 1.0,
                        beta: float = 0.9, v_th1: float = 1.0,
                        v_th2: float = 0.6, v_reset: float = 0.0,
                        v_lim: float = 8.0, use_snl: bool = True,
                        ima_noise=None, snl_amp: float = 0.0,
                        n_valid: int | None = None,
                        mac_telemetry: bool = True):
    """A whole KWN event sequence, step by step.

    x (T, M, K) ternary, msb/lsb (K, N) int8 planes, boundaries
    (n_codes - 1,), levels (n_codes,), scale (N,), v (M, N) initial
    membrane, noise (T, M, N) pre-drawn SNL noise or None for the counter
    streams (IMA error via ``ima_noise``, SNL sign noise at ``snl_amp``),
    row_ctl (M, 3) int32: the counters of row ``i`` at step ``t`` are
    ``(row_ctl[i, 0], row_ctl[i, 1] + t, row_ctl[i, 2], column)``.

    Returns (mac (T, M, N) or None, v_out (M, N), spikes (T, M, N),
    mask (T, M, N), adc_steps (T, M, 1) int32).
    """
    t_steps = x.shape[0]
    n = msb.shape[-1]
    dev = x.device
    n_codes = levels.shape[0]
    n_valid = n if n_valid is None else n_valid
    w = ratio * msb.float() + lsb.float()
    bounds = boundaries.float().to(dev)
    levels = levels.float().to(dev)
    scale = scale.float().reshape(-1).to(dev)
    rc = row_ctl.to(dev, torch.int64)
    seeds, steps0, rows = rc[:, 0:1], rc[:, 1:2], rc[:, 2:3]
    cols = torch.arange(n, device=dev, dtype=torch.int64)[None, :]
    pad_col = cols >= n_valid
    lif = dict(beta=beta, v_th1=v_th1, v_th2=v_th2, v_reset=v_reset,
               v_lim=v_lim, use_snl=use_snl)
    v = v.float()
    macs, spikes, masks, steps = [], [], [], []
    for t in range(t_steps):
        mac = x[t].float() @ w
        codes = ramp_codes(mac, bounds)
        if ima_noise is not None:
            codes = ctrprng.noisy_ima_codes(codes, mac, rows, cols, seeds,
                                            steps0 + t, ima_noise, n_codes)
        codes = torch.where(pad_col, torch.full_like(codes, -1), codes)
        maskf, st = kwn_select(codes, k, n_codes)
        recon = torch.where(codes >= 0, levels[codes.clamp(min=0).long()],
                            torch.zeros_like(mac))
        drive = recon * scale * maskf * drive_gain
        if noise is not None:
            nz = noise[t].float()
        elif use_snl and snl_amp != 0.0:
            sign = ctrprng.counter_sign(seeds, steps0 + t, rows, cols,
                                        ctrprng.TAG_SNL)
            nz = torch.tensor(snl_amp, dtype=torch.float32) * sign
        else:
            nz = torch.zeros_like(v)
        v, spk = lif_update(v, drive, maskf, nz, **lif)
        if mac_telemetry:
            macs.append(mac)
        spikes.append(spk)
        masks.append(maskf)
        steps.append(st)
    return (torch.stack(macs) if mac_telemetry else None, v,
            torch.stack(spikes), torch.stack(masks), torch.stack(steps))


def fused_macro_seq_nld_ref(x, msb, lsb, boundaries, levels, scale, w_dend,
                            v, *, row_ctl, ratio: float = 2.0,
                            drive_gain: float = 1.0, beta: float = 0.9,
                            v_th1: float = 1.0, v_reset: float = 0.0,
                            v_lim: float = 8.0, logical_n: int | None = None,
                            ima_noise=None, mac_telemetry: bool = True):
    """A whole NLD event sequence, step by step.

    x (T, M, K) ternary, msb/lsb (K, J*N) int8 branch-major planes, scale
    (J*N,), w_dend (J, N), v (M, N).  Per step: ``mac * scale``, the
    activation ramp's codes (plus the counter noise on the logical column
    ``j * logical_n + p``), the LUT, the soma sum ``sum_j act_j *
    w_dend_j`` as a fused multiply-add chain in branch order, ``*
    drive_gain``, then a dense LIF update without SNL.

    Returns (mac (T, M, J*N) or None, v_out (M, N), spikes (T, M, N),
    mask (T, M, N) all ones, adc_steps (T, M, 1) all ``n_codes - 1``).
    """
    t_steps, m = x.shape[0], x.shape[1]
    n_branches, n = w_dend.shape
    dev = x.device
    n_codes = levels.shape[0]
    logical_n = n if logical_n is None else logical_n
    w = ratio * msb.float() + lsb.float()
    bounds = boundaries.float().to(dev)
    levels = levels.float().to(dev)
    scale = scale.float().reshape(-1).to(dev)
    w_dend = w_dend.float().to(dev)
    rc = row_ctl.to(dev, torch.int64)
    seeds, steps0, rows = rc[:, 0:1], rc[:, 1:2], rc[:, 2:3]
    col = torch.arange(n_branches * n, device=dev, dtype=torch.int64)
    lcol = ((col // n) * logical_n + col % n)[None, :]
    ones = torch.ones((m, n), dtype=torch.float32, device=dev)
    zeros = torch.zeros((m, n), dtype=torch.float32, device=dev)
    v = v.float()
    macs, spikes = [], []
    for t in range(t_steps):
        mac = x[t].float() @ w
        mac_f = mac * scale
        codes = ramp_codes(mac_f, bounds)
        if ima_noise is not None:
            codes = ctrprng.noisy_ima_codes(codes, mac_f, rows, lcol, seeds,
                                            steps0 + t, ima_noise, n_codes)
        act = levels[codes.long()].reshape(m, n_branches, n)
        drive = act[:, 0] * w_dend[0]
        for j in range(1, n_branches):
            drive = f32math.fma(act[:, j], w_dend[j], drive)
        v, spk = lif_update(v, drive * drive_gain, ones, zeros, beta=beta,
                            v_th1=v_th1, v_th2=v_th1, v_reset=v_reset,
                            v_lim=v_lim, use_snl=False)
        if mac_telemetry:
            macs.append(mac)
        spikes.append(spk)
    spikes = torch.stack(spikes)
    return (torch.stack(macs) if mac_telemetry else None, v, spikes,
            torch.ones_like(spikes),
            torch.full((t_steps, m, 1), n_codes - 1, dtype=torch.int32,
                       device=dev))


def _tile_occupancy(x: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    """Occupied K tiles per (step, row tile) of a (T, M, K) input: the
    count of ``bk``-wide K tiles (ragged tail allowed) holding a non-zero
    in some row of the ``bm``-row tile.  (T, M/bm) int32."""
    t_steps, m, k_dim = x.shape
    n_k = -(-k_dim // bk)
    xp = torch.nn.functional.pad((x != 0).float(), (0, n_k * bk - k_dim))
    occ = xp.reshape(t_steps, m // bm, bm, n_k, bk).amax(dim=(2, 4))
    return occ.sum(-1).to(torch.int32)


def fused_macro_multi_seq_ref(x, planes, v0s, noises, activity, ctl, *,
                              specs, ratio: float = 2.0,
                              drive_gain: float = 1.0, beta: float = 0.9,
                              v_th1: float = 1.0, v_th2: float = 0.6,
                              v_reset: float = 0.0, v_lim: float = 8.0,
                              use_snl: bool = True, bm: int = 128,
                              ima_noise=None, snl_amp: float = 0.0):
    """L stacked KWN layers, layer by layer: layer l's spike stack is layer
    l+1's input sequence, which computes the same values as the kernel's
    step-major order (layer l+1 at step t reads only its own membrane and
    layer l's step-t spikes).  Layer l's counters are
    ``(ctl[l], ctl[L] + t, absolute row, column)``.

    Returns what ``kernels.fused_macro.fused_macro_multi_seq`` returns:
    (v_outs, spikes, mask, steps (L, T, M), counts (L, T, M),
    occupancy (L, T, M/bm)); layer 0's occupancy counts the occupied
    blocks of ``activity``, deeper layers' the K tiles of the previous
    layer's spikes.
    """
    t_steps, m = x.shape[0], x.shape[1]
    n_layers = len(specs)
    ctl = [int(c) for c in ctl.reshape(-1).tolist()]
    rows = torch.arange(m, dtype=torch.int32, device=x.device)
    cur = x
    v_outs, steps, counts, occ = [], [], [], []
    spk = mask = None
    for li, (spec, (msb, lsb, bounds, levels, scale)) in enumerate(
            zip(specs, planes)):
        rc = torch.stack([torch.full_like(rows, ctl[li]),
                          torch.full_like(rows, ctl[n_layers]), rows], -1)
        _, v_fin, spk, mask, st = fused_macro_seq_ref(
            cur, msb, lsb, bounds, levels, scale, v0s[li],
            None if noises is None else noises[li], row_ctl=rc, k=spec.k,
            ratio=ratio, drive_gain=drive_gain, beta=beta, v_th1=v_th1,
            v_th2=v_th2, v_reset=v_reset, v_lim=v_lim, use_snl=use_snl,
            ima_noise=ima_noise, snl_amp=snl_amp, mac_telemetry=False)
        if li == 0:
            occ.append((activity > 0).sum(-1).to(torch.int32))
        else:
            occ.append(_tile_occupancy(cur, bm, spec.bk))
        v_outs.append(v_fin)
        steps.append(st[..., 0])
        counts.append(spk.sum(-1))
        cur = spk
    return (tuple(v_outs), spk, mask, torch.stack(steps),
            torch.stack(counts), torch.stack(occ))
