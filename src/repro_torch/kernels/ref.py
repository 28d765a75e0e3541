"""Plain PyTorch versions of the fused macro kernels.

Counterparts of ``repro.kernels.ref``: ``fused_macro_seq_ref`` (KWN mode,
``fused_head_ref`` / ``fused_macro_step_ref`` folded left over T, with
``counter_snl_noise`` for the in-kernel SNL stream),
``fused_macro_seq_nld_ref`` (the NLD head) and
``fused_macro_multi_seq_ref`` (the KWN stack, layer by layer), and the
four single-stage kernels of the composed chain: ``ternary_mac_ref``,
``nlq_convert_ref``, ``kwn_topk_ref`` and ``lif_step_ref``, and the LM
stack's attention forward ``flash_attention_ref``.  Each is the
function its wrapper in ``kernels`` computes for a CPU tensor, and the
yardstick its CUDA kernel is held against on the card; it is never a
fallback for a CUDA tensor.

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
from repro_torch.core import kwn as kwn_lib
from repro_torch.core import ternary as ternary_lib
from repro_torch.core.lif import lif_update


def ramp_codes(mac: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """Ramp conversion: code = number of boundaries strictly below."""
    return (mac[..., None] > boundaries).sum(-1).to(torch.int32)


def kwn_select(codes: torch.Tensor, k: int, n_codes: int):
    """Descending-ramp priority-encoded top-K on a (M, N) code plane
    (``core.kwn.select_codes``; code -1 never wins).  Returns (mask f32
    (M, N), steps int32 (M, 1))."""
    res = kwn_lib.select_codes(codes, k, n_codes)
    return res.mask, res.adc_steps[..., None]


# --- the single-stage kernels of the composed chain -------------------------

def ternary_mac_ref(x: torch.Tensor, msb: torch.Tensor, lsb: torch.Tensor,
                    ratio: float = 2.0) -> torch.Tensor:
    """Twin-cell GEMM: x (M, K) ternary against ``ratio * msb + lsb``,
    (K, N) ternary planes -> (M, N) f32.

    Both plane products are exact small integers, so the result is
    ``fma(ratio, x @ msb, x @ lsb)``, rounded once: the reference's f32
    product exactly for an integral ratio (while |MAC| < 2^24), and
    within its accumulation error otherwise."""
    xf = x.float()
    return f32math.fma(ratio, xf @ msb.float(), xf @ lsb.float())


def nlq_convert_ref(x: torch.Tensor, boundaries: torch.Tensor,
                    levels: torch.Tensor):
    """Ramp codes (boundaries strictly below) and the LUT map-back: the
    reference's one-hot sum, whose other terms are zeros, is a gather.
    Returns (codes int32, reconstruction f32), both shaped like ``x``."""
    codes = ramp_codes(x.float(), boundaries.float())
    return codes, levels.float()[codes.long()]


def kwn_topk_ref(mac: torch.Tensor, boundaries: torch.Tensor, k: int):
    """Ramp codes, then the full descending priority-encoder sweep: (mask
    (M, N) f32, adc_steps (M, 1) int32).  ``k <= 0`` admits no column and
    stops at step 0, as the sweep's first level already has K winners;
    ``k >= N`` admits every column."""
    n_codes = boundaries.shape[0] + 1
    if k <= 0:
        return (torch.zeros(mac.shape, dtype=torch.float32,
                            device=mac.device),
                torch.zeros((*mac.shape[:-1], 1), dtype=torch.int32,
                            device=mac.device))
    return kwn_select(ramp_codes(mac.float(), boundaries.float()), k,
                      n_codes)


def lif_step_ref(v, drive, mask, noise, *, beta: float = 0.9,
                 v_th1: float = 1.0, v_th2: float = 0.6,
                 v_reset: float = 0.0, v_lim: float = 8.0,
                 use_snl: bool = True):
    """The elementwise LIF of the reference's kernel: winners ``fma(beta,
    v, drive)`` (the kernel body is compiled and contracted; the eager
    oracle ``beta * v + drive`` rounds twice), the SNL kick, the clip, the
    compare and the reset.  Returns (v_out, spikes)."""
    v_out, spike, _ = lif_update(v.float(), drive.float(), mask.float(),
                                 noise.float(), beta=beta, v_th1=v_th1,
                                 v_th2=v_th2, v_reset=v_reset, v_lim=v_lim,
                                 use_snl=use_snl)
    return v_out, spike


def fused_macro_seq_ref(x, msb, lsb, boundaries, levels, scale, v,
                        noise=None, *, row_ctl, k: int = 12,
                        ratio: float = 2.0, drive_gain: float = 1.0,
                        beta: float = 0.9, v_th1: float = 1.0,
                        v_th2: float = 0.6, v_reset: float = 0.0,
                        v_lim: float = 8.0, use_snl: bool = True,
                        ima_noise=None, snl_amp: float = 0.0,
                        n_valid: int | None = None,
                        mac_telemetry: bool = True,
                        train_trace: bool = False):
    """A whole KWN event sequence, step by step.

    x (T, M, K) ternary, msb/lsb (K, N) int8 planes, boundaries
    (n_codes - 1,), levels (n_codes,), scale (N,), v (M, N) initial
    membrane, noise (T, M, N) pre-drawn SNL noise or None for the counter
    streams (IMA error via ``ima_noise``, SNL sign noise at ``snl_amp``),
    row_ctl (M, 3) int32: the counters of row ``i`` at step ``t`` are
    ``(row_ctl[i, 0], row_ctl[i, 1] + t, row_ctl[i, 2], column)``.

    Returns (mac (T, M, N) or None, v_out (M, N), spikes (T, M, N),
    mask (T, M, N), adc_steps (T, M, 1) int32), and with ``train_trace``
    also vtrace (T, M, N): the saturated membrane before the reset.
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
    macs, spikes, masks, steps, trace = [], [], [], [], []
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
        v, spk, v_clip = lif_update(v, drive, maskf, nz, **lif)
        if mac_telemetry:
            macs.append(mac)
        spikes.append(spk)
        masks.append(maskf)
        steps.append(st)
        trace.append(v_clip)
    out = (torch.stack(macs) if mac_telemetry else None, v,
           torch.stack(spikes), torch.stack(masks), torch.stack(steps))
    return out + (torch.stack(trace),) if train_trace else out


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
        v, spk, _ = lif_update(v, drive * drive_gain, ones, zeros, beta=beta,
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


# --- silicon training: the surrogate backward and its autograd oracle -------

def fused_macro_seq_grad_ref(x, scale, g_spk, g_vfin, vtrace, mask,
                             mac=None, msb=None, lsb=None, activity=None, *,
                             ratio: float = 2.0, drive_gain: float = 1.0,
                             beta: float = 0.9, v_th1: float = 1.0,
                             v_lim: float = 8.0, kwn_relax: float = 0.0,
                             surrogate_beta: float = 4.0,
                             ste_lo: float = -24.5, ste_hi: float = 24.5):
    """The surrogate backward of the KWN sequence (padded operands).

    x (T, M, K) ternary, scale (N,) (padded columns zero: they drop out of
    ``dW`` by themselves), g_spk / vtrace / mask (T, M, N) f32, g_vfin
    (M, N), mac (T, M, N) the forward's MAC residual, or None to recompute
    it from the (K, N) int8 planes ``msb`` / ``lsb`` (exact small integers,
    so both give the same bits), activity (T, M / bm) int32 row-tile
    occupancy or None: a (step, row tile) whose word is 0 adds nothing.

    Walks reversed time in the backward kernel's operation order:
    SuperSpike ``sbeta / (1 + |sbeta (vt - v_th1)|)^2`` through the spike,
    the reset's cut ``1 - spike``, the rail cut ``|vt| < v_lim``, the carry
    (winners leak by ``beta``, the rest hold), and ``g_mac = g_v2 * (m +
    kwn_relax (1 - m)) * scale * drive_gain * [ste_lo <= mac <= ste_hi]``;
    then ``dW = sum_t x_t^T g_mac_t`` as one matrix product.
    Returns (dW (K, N) f32, dv0 (M, N) f32).
    """
    t_steps, m, k_dim = x.shape
    xf = x.float()
    if mac is None:
        mac = xf @ (ratio * msb.float() + lsb.float())
    in_ramp = ((mac >= ste_lo) & (mac <= ste_hi)).float()
    scale = scale.float().reshape(-1)
    g_v = g_vfin.float()
    g_mac = torch.empty_like(vtrace)
    for t in reversed(range(t_steps)):
        vt, mt = vtrace[t], mask[t]
        spk = (vt >= v_th1).float()
        d = 1.0 + (surrogate_beta * (vt - v_th1)).abs()
        sg = torch.full_like(d, surrogate_beta) / (d * d)   # IEEE quotient
        g_vclip = g_v * (1.0 - spk) + g_spk[t] * sg
        g_v2 = g_vclip * (vt.abs() < v_lim).float()
        g_v = g_v2 * (mt * beta + (1.0 - mt))
        gate = mt + kwn_relax * (1.0 - mt)
        g_mac[t] = g_v2 * gate * scale * drive_gain * in_ramp[t]
    if activity is not None:
        row_on = (activity > 0).repeat_interleave(m // activity.shape[1], 1)
        xf = torch.where(row_on[..., None], xf, torch.zeros_like(xf))
    n = vtrace.shape[-1]
    dw = xf.reshape(-1, k_dim).t() @ g_mac.reshape(-1, n)
    return dw, g_v


def _ste(exact: torch.Tensor, surrogate: torch.Tensor) -> torch.Tensor:
    """Value ``exact`` (bit for bit), gradient the surrogate's."""
    return exact.detach() + (surrogate - surrogate.detach())


class _SpikeSurrogate(torch.autograd.Function):
    """``v >= v_th`` with the SuperSpike fast-sigmoid gradient."""

    @staticmethod
    def forward(ctx, v, v_th: float, sbeta: float):
        ctx.save_for_backward(v)
        ctx.v_th, ctx.sbeta = v_th, sbeta
        return (v >= v_th).float()

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        d = 1.0 + (ctx.sbeta * (v - ctx.v_th)).abs()
        return g * (torch.full_like(d, ctx.sbeta) / (d * d)), None, None


class _SatClip(torch.autograd.Function):
    """V_mem register saturation; the gradient passes strictly inside the
    rails (``clamp`` would pass it at a rail too)."""

    @staticmethod
    def forward(ctx, v, lim: float):
        out = torch.clamp(v, -lim, lim)
        ctx.save_for_backward(out)
        ctx.lim = lim
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return g * (out.abs() < ctx.lim).float(), None


def fused_macro_seq_vjp_ref(w, x, boundaries, levels, scale, v, noise=None,
                            *, k: int = 12, ratio: float = 2.0,
                            drive_gain: float = 1.0, beta: float = 0.9,
                            v_th1: float = 1.0, v_th2: float = 0.6,
                            v_reset: float = 0.0, v_lim: float = 8.0,
                            use_snl: bool = True, ima_noise=None,
                            snl_amp: float = 0.0, seed: int = 0,
                            step_offset: int = 0, kwn_relax: float = 0.0,
                            surrogate_beta: float = 4.0,
                            ste_lo: float | None = None,
                            ste_hi: float | None = None):
    """Differentiable KWN sequence in autograd: the gradient semantics the
    backward kernel reproduces (counterpart of the reference's
    ``fused_macro_seq_vjp_ref``).

    ``w`` (K, N) is the float weight in integer MAC units: the value path
    rounds it onto the twin-cell grid, the gradient passes straight
    through.  ``x`` (T, M, K) ternary f32 events carry no gradient.  The
    values equal ``fused_macro_seq_ref`` bit for bit; the gradients are
    straight through the MAC and inside the ramp's window
    ``[ste_lo, ste_hi]`` (default: the levels' span +-0.5), the relaxed
    winner gate (losers leak ``kwn_relax``), SuperSpike through the spike,
    the rail cut, and nothing through the reset's selection or the noise.

    Returns (v_fin, spikes (T, M, N), mask (T, M, N), adc_steps
    (T, M, 1), vtrace (T, M, N)).
    """
    dev = x.device
    msb, lsb = ternary_lib.weight_decompose(w.detach())
    w_exact = ratio * msb + lsb
    bounds = boundaries.float().to(dev)
    levels = levels.float().to(dev)
    n_codes = levels.shape[0]
    scale = scale.float().reshape(-1).to(dev).detach()
    ste_lo = float(levels.min()) - 0.5 if ste_lo is None else ste_lo
    ste_hi = float(levels.max()) + 0.5 if ste_hi is None else ste_hi
    m, n = x.shape[1], w.shape[1]
    rows = torch.arange(m, device=dev, dtype=torch.int64)[:, None]
    cols = torch.arange(n, device=dev, dtype=torch.int64)[None, :]
    spikes, masks, steps, trace = [], [], [], []
    for t in range(x.shape[0]):
        xt = x[t].float()
        mac_e = xt @ w_exact
        mac = _ste(mac_e, xt @ w)
        codes = ramp_codes(mac_e, bounds)
        if ima_noise is not None:
            codes = ctrprng.noisy_ima_codes(codes, mac_e, rows, cols, seed,
                                            step_offset + t, ima_noise,
                                            n_codes)
        maskf, st = kwn_select(codes, k, n_codes)
        drive_exact = levels[codes.long()] * scale * maskf * drive_gain
        rng = ((mac_e >= ste_lo) & (mac_e <= ste_hi)).float()
        drive_sur = mac * scale * drive_gain * rng
        drive_w = _ste(drive_exact, drive_sur)
        v_lose = v
        if kwn_relax != 0.0:
            leak = kwn_relax * drive_sur
            v_lose = v + (leak - leak.detach())
        v_win = _ste(f32math.fma(beta, v.detach(), drive_exact),
                     beta * v + drive_w)
        v2 = torch.where(maskf > 0, v_win, v_lose)
        if use_snl:
            if noise is not None:
                nz = noise[t].float()
            else:
                nz = snl_amp * ctrprng.counter_sign(
                    seed, step_offset + t, rows, cols, ctrprng.TAG_SNL)
            vd = v2.detach()
            v2 = torch.where((vd > v_th2) & (vd < v_th1), v2 + nz, v2)
        v_clip = _SatClip.apply(v2, v_lim)
        s = _SpikeSurrogate.apply(v_clip, v_th1, surrogate_beta)
        v = torch.where(s.detach() > 0, torch.full_like(v_clip, v_reset),
                        v_clip)
        spikes.append(s)
        masks.append(maskf)
        steps.append(st)
        trace.append(v_clip)
    return (v, torch.stack(spikes), torch.stack(masks), torch.stack(steps),
            torch.stack(trace))


# --- the LM stack's attention forward ---------------------------------------

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Attention forward, q / k / v (BH, S, D) f32 or bf16 -> (BH, S, D) in
    q's dtype: the function of the reference's ``_flash_kernel``.

    Scores ``q.k * (1 / sqrt(D))`` in f32, masked ``row >= col`` with
    -1e30 when causal, softmax, ``p @ v`` in f32, divided by
    ``max(l, 1e-30)``, rounded once to q's dtype.  One softmax over the
    whole row instead of the kernel's online one: the two differ only in
    the order of the sums.
    """
    d = q.shape[-1]
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / d ** 0.5)
    if causal:
        n = q.shape[-2]
        rows = torch.arange(n, device=q.device)
        s = s.masked_fill(rows[:, None] < rows[None, :], NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    return ((p @ v.float()) / torch.clamp(l, min=1e-30)).to(q.dtype)
