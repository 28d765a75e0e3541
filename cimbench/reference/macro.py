"""The benchmark's plain reference of the macro's SNN: inference through
the macro in KWN and NLD mode, and one step of silicon-in-the-loop
training, in plain PyTorch.

It imports nothing of the program and takes nothing the program has made:
from the raw weights, events, labels and seeds that the benchmark hands
both sides it works out the twin-cell planes, the ramp codebooks, the
noise streams and the activity tiles again, then folds the macro's step
over time.  The step is the one the fused kernels compute: the twin-cell
MAC ``x @ (2 msb + lsb)`` (small exact integers), the ramp conversion
(with the Fig. 7 error from the counter PRNG where asked), the KWN
descending-ramp sweep with early stop or the NLD activation LUT and soma
sum, and the LIF with SNL, every rounding as the kernels round (frozen
copies of ``repro_torch.kernels.ref``, ``core.ternary``, ``core.kwn``,
``core.lif`` and ``train.silicon``).

Every product goes through ``mm``.  With ``tf32=True`` its operands are
rounded to TF32 (10 mantissa bits), forward and backward: the control,
the same mathematics in the precision one step below the configuration's
float32.
"""

from __future__ import annotations

import math

import torch

from cimbench.reference import codebook, ctrprng, f32math, prbs

V_RESET = 0.0
V_LIM = float(2 ** 11) / 256.0    # the 12-bit V_mem register, 8 fraction bits
RATIO = 2.0                       # I_MSB / I_LSB of the twin cell
SURROGATE_BETA = 4.0              # SuperSpike sharpness of the training path


# --- the precision of the products ------------------------------------------

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 mantissa bits (to nearest, ties
    away from zero, as the tensor cores convert)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _MMTF32(torch.autograd.Function):
    """``a @ b`` on TF32 operands, its gradients on TF32 operands too."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(b).t(), round_tf32(a).t() @ g


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    return _MMTF32.apply(a, b) if tf32 else a @ b


# --- the macro's operands ---------------------------------------------------

def quantize_3bit(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-column symmetric quantization onto the twin cell's [-3, 3]:
    (w_int, scale (1, N)), rounding half to even."""
    dims = tuple(range(w.dim() - 1))
    scale = f32math.div(torch.amax(torch.abs(w), dim=dims, keepdim=True), 3.0)
    scale = torch.clamp(scale, min=1e-8)
    return torch.round(torch.clamp(w / scale, -3, 3)), scale


def twin_weights(w_int: torch.Tensor) -> torch.Tensor:
    """The weight the twin cell realizes, ``2 msb + lsb`` with ``msb =
    round(w / 2)`` (half to even) and ``lsb = w - 2 msb``."""
    w = torch.round(torch.clamp(w_int, -3, 3))
    msb = torch.clamp(torch.round(w / 2.0), -1.0, 1.0)
    return RATIO * msb + (w - 2.0 * msb)


def kwn_operands(w_hid: torch.Tensor):
    """(twin weights (K, N), per-column scale (N,))."""
    w_int, scale = quantize_3bit(w_hid)
    return twin_weights(w_int), scale.reshape(-1)


def nld_operands(w_syn, w_dend, mask):
    """Branch weights on the twin-cell grid: (weights (K, J*N)
    branch-major, scale (J*N,), w_dend (J, N))."""
    w = w_syn * mask                                       # (J, I, N)
    n_branches, n_in, n_out = w.shape
    scale = torch.clamp(f32math.div(torch.amax(torch.abs(w), dim=1), 3.0),
                        min=1e-8)                          # (J, N)
    w_int = torch.round(torch.clamp(f32math.div(w, scale[:, None, :]),
                                    -3, 3))
    flat = twin_weights(w_int).permute(1, 0, 2).reshape(
        n_in, n_branches * n_out)
    return flat, scale.reshape(-1).float(), w_dend.float()


# --- the stages of one step --------------------------------------------------

def ramp_codes(mac: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """The count of boundaries strictly below (a subnormal compares as a
    zero)."""
    mac = f32math.flush_subnormal(mac)
    return (mac[..., None] > boundaries).sum(-1).to(torch.int32)


def kwn_select(codes: torch.Tensor, k: int, n_codes: int):
    """Descending-ramp top-K with early stop: columns win by descending
    code, ties to the lower index.  Returns (mask f32, adc_steps int32):
    the steps are ``n_codes - 1`` minus the K-th winner's code, or
    ``n_codes - 1`` where fewer than K can win."""
    n = codes.shape[-1]
    idx = torch.arange(n, device=codes.device, dtype=torch.int64)
    key = codes.to(torch.int64) * n + (n - 1 - idx)
    top_key, top_idx = torch.topk(key, min(k, n), dim=-1)
    top_code = torch.div(top_key, n, rounding_mode="floor")
    valid = top_code >= 0
    mask = torch.zeros(codes.shape, dtype=torch.float32, device=codes.device)
    mask.scatter_(-1, top_idx, valid.float())
    reached = valid.sum(-1) >= k
    steps = torch.where(reached, n_codes - 1 - top_code[..., -1],
                        torch.full_like(top_code[..., -1], n_codes - 1))
    return mask, steps.to(torch.int32)


def lif_update(v, drive, mask, noise, *, beta, v_th1, v_th2, use_snl):
    """Eq. (1): winners leak and integrate (one fused multiply-add), the
    rest hold; the SNL kick inside (v_th2, v_th1); saturate; compare;
    reset.  Returns (v_out, spikes)."""
    v_new = torch.where(mask > 0, f32math.fma(beta, v, drive), v)
    if use_snl:
        snl = (v_new > v_th2) & (v_new < v_th1)
        v_new = torch.where(snl, v_new + noise, v_new)
    v_new = torch.clamp(v_new, -V_LIM, V_LIM)
    spike = (v_new >= v_th1).float()
    return torch.where(spike > 0, torch.full_like(v_new, V_RESET),
                       v_new), spike


# --- inference ----------------------------------------------------------------

def _activity_skipped(x: torch.Tensor) -> torch.Tensor:
    """The share of the activity tiles that hold no event, over (T, row
    tiles, K tiles): tiles of ``min(128, B rounded up to 8)`` streams by
    256 inputs (one physical macro; ``K`` rounded up to 128 below 256),
    the rows and inputs zero-padded to whole tiles."""
    t_steps, b, k_dim = x.shape
    bm = min(128, max(8, -(-b // 8) * 8))
    bk = 256 if k_dim >= 256 else max(128, -(-k_dim // 128) * 128)
    m_pad, k_pad = -(-b // bm) * bm, -(-k_dim // bk) * bk
    occ = torch.nn.functional.pad(x != 0, (0, k_pad - k_dim, 0, m_pad - b))
    occ = occ.reshape(t_steps, m_pad // bm, bm, k_pad // bk, bk)
    tiles = occ.any(dim=4).any(dim=2)
    frac = f32math.div(tiles.float().sum(), tiles.numel())
    return torch.clamp(1.0 - frac, 0.0, 1.0)


def forward(params: dict, events: torch.Tensor, cfg: dict, seed: int,
            noise: codebook.IMANoiseModel | None, tf32: bool = False):
    """Inference through the macro: events (B, T, K) ternary f32 ->
    (logits (B, classes), telemetry), as ``forward_silicon(fused="seq")``
    defines them.

    ``params``: ``w_hid`` (K, N) and ``w_out`` (N, classes) in KWN mode,
    ``w_syn`` / ``mask`` (J, K, N), ``w_dend`` (J, N) and ``w_out`` in NLD
    mode.  ``cfg``: the configuration file's ``snn`` fields.  Clean KWN
    kicks the SNL from the PRBS-15 stream; with ``noise`` (the Fig. 7
    model) the IMA error and the SNL sign come from the counter PRNG keyed
    on ``seed``.  Telemetry: per-stream means over T of the ADC steps,
    the LIF updates and the SOPs, and the skipped share of the activity
    tiles.
    """
    dev = events.device
    x = torch.clamp(torch.round(events), -1, 1).transpose(0, 1)  # (T, B, K)
    t_steps, b, _ = x.shape
    n = cfg["n_hidden"]
    nld = cfg["mode"] == "nld"
    bits = cfg["code_bits"]
    if nld:
        w, scale, w_dend = nld_operands(params["w_syn"], params["w_dend"],
                                        params["mask"])
        rng = cfg["dend_range"]
        cb = codebook.activation_codebook(
            bits, codebook.DENDRITE_ACTIVATIONS[cfg["activation"]], -rng, rng)
    else:
        w, scale = kwn_operands(params["w_hid"])
        rng = cfg["mac_range"]
        cb = codebook.nlq_codebook(bits, -rng, rng)
    bounds, levels = cb.boundaries.to(dev), cb.levels.to(dev)
    n_codes = levels.shape[0]
    kn = None if noise is None else codebook.kernel_noise_params(noise, cb)
    snl = cfg["use_snl"] and not nld
    amp = cfg["noise_amp"] if snl else 0.0
    kicks = None
    if snl and noise is None:
        kicks = prbs.sequence_noise(b, t_steps, n, amp, dev)
    rows = torch.arange(b, device=dev, dtype=torch.int64)[:, None]
    col = torch.arange(w.shape[1], device=dev, dtype=torch.int64)[None, :]
    lif = dict(beta=cfg["beta"], v_th1=cfg["v_th1"], v_th2=cfg["v_th2"])
    v = torch.zeros((b, n), device=dev)
    counts = torch.zeros((b, n), device=dev)
    adc = torch.zeros((b,), device=dev)
    for t in range(t_steps):
        mac = mm(x[t], w, tf32)
        if nld:
            mac = mac * scale
            codes = ramp_codes(mac, bounds)
            if kn is not None:     # branch-major columns are the logical ones
                codes = ctrprng.noisy_ima_codes(codes, mac, rows, col, seed,
                                                t, kn, n_codes)
            act = levels[codes.long()].reshape(b, -1, n)
            drive = act[:, 0] * w_dend[0]
            for j in range(1, act.shape[1]):
                drive = f32math.fma(act[:, j], w_dend[j], drive)
            v, spk = lif_update(v, drive * cfg["drive_gain"],
                                torch.ones_like(v), None, beta=lif["beta"],
                                v_th1=lif["v_th1"], v_th2=lif["v_th1"],
                                use_snl=False)
            steps = torch.full((b,), n_codes - 1, device=dev)
        else:
            codes = ramp_codes(mac, bounds)
            if kn is not None:
                codes = ctrprng.noisy_ima_codes(codes, mac, rows, col, seed,
                                                t, kn, n_codes)
            mask, steps = kwn_select(codes, cfg["k"], n_codes)
            drive = levels[codes.long()] * scale * mask * cfg["drive_gain"]
            if kicks is not None:
                nz = kicks[t]
            elif snl:
                nz = amp * ctrprng.counter_sign(seed, t, rows, col,
                                                ctrprng.TAG_SNL)
            else:
                nz = torch.zeros_like(v)
            v, spk = lif_update(v, drive, mask, nz, use_snl=snl, **lif)
        counts = counts + spk
        adc = adc + steps.float()
    logits = mm(f32math.div(counts, t_steps), params["w_out"], tf32)
    sops = (x.abs().sum(-1) * n).sum(0)
    tele = {
        "adc_steps": f32math.div(adc, t_steps),
        "lif_updates": torch.full((b,), float(n if nld else cfg["k"]),
                                  device=dev),
        "sops": f32math.div(sops, t_steps),
        "skipped_block_ratio": _activity_skipped(x).expand(b),
    }
    return logits, tele


# --- silicon-in-the-loop training ---------------------------------------------

def _ste(exact: torch.Tensor, surrogate: torch.Tensor) -> torch.Tensor:
    """Value ``exact``, bit for bit; gradient the surrogate's."""
    return exact.detach() + (surrogate - surrogate.detach())


class _Spike(torch.autograd.Function):
    """``v >= v_th``, with the SuperSpike gradient
    ``beta / (1 + |beta (v - v_th)|)^2``."""

    @staticmethod
    def forward(ctx, v, v_th: float):
        ctx.save_for_backward(v)
        ctx.v_th = v_th
        return (v >= v_th).float()

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        d = 1.0 + (SURROGATE_BETA * (v - ctx.v_th)).abs()
        return g * (torch.full_like(d, SURROGATE_BETA) / (d * d)), None


class _SatClip(torch.autograd.Function):
    """The V_mem register's saturation; the gradient passes strictly
    inside the rails."""

    @staticmethod
    def forward(ctx, v):
        out = torch.clamp(v, -V_LIM, V_LIM)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return g * (out.abs() < V_LIM).float()


def train_loss(params: dict, events: torch.Tensor, labels: torch.Tensor,
               cfg: dict, seed: int, noise: codebook.IMANoiseModel | None,
               kwn_relax: float, tf32: bool = False) -> torch.Tensor:
    """Cross-entropy of the silicon forward, differentiable as
    ``snn.loss_fn(silicon=True)`` defines it (KWN, one layer).

    The values are the inference path's, bit for bit; the gradient is a
    surrogate: straight through the clipped twin-cell rounding (in integer
    MAC units) and inside the ramp's window ``+-(mac_range + 0.5)``, the
    KWN gate relaxed by ``kwn_relax`` for the losers, SuperSpike through
    the spike, cut at the V_mem rails, nothing through the reset or the
    noise.
    """
    dev = events.device
    x = torch.clamp(torch.round(events), -1, 1).transpose(0, 1)
    t_steps, b, _ = x.shape
    n, k = cfg["n_hidden"], cfg["k"]
    w_hid = params["w_hid"]
    w_int, scale2 = quantize_3bit(w_hid)
    scale2 = scale2.detach()
    w_sur = f32math.div(w_hid, scale2)
    clip = (w_sur.detach().abs() <= 3.5).float()
    w = w_int.detach() + (w_sur - w_sur.detach()) * clip   # integer units
    scale = scale2.reshape(-1)
    w_exact = twin_weights(w.detach())
    rng = cfg["mac_range"]
    cb = codebook.nlq_codebook(cfg["code_bits"], -rng, rng)
    bounds, levels = cb.boundaries.to(dev), cb.levels.to(dev)
    n_codes = levels.shape[0]
    kn = None if noise is None else codebook.kernel_noise_params(noise, cb)
    snl = cfg["use_snl"]
    amp = cfg["noise_amp"] if snl else 0.0
    kicks = None
    if snl and noise is None:
        kicks = prbs.sequence_noise(b, t_steps, n, amp, dev)
    gain, beta = cfg["drive_gain"], cfg["beta"]
    v_th1, v_th2 = cfg["v_th1"], cfg["v_th2"]
    rows = torch.arange(b, device=dev, dtype=torch.int64)[:, None]
    cols = torch.arange(n, device=dev, dtype=torch.int64)[None, :]
    v = torch.zeros((b, n), device=dev)
    counts = torch.zeros((b, n), device=dev)
    for t in range(t_steps):
        xt = x[t]
        mac_e = mm(xt, w_exact, tf32)
        mac = _ste(mac_e, mm(xt, w, tf32))
        codes = ramp_codes(mac_e, bounds)
        if kn is not None:
            codes = ctrprng.noisy_ima_codes(codes, mac_e, rows, cols, seed,
                                            t, kn, n_codes)
        maskf, _ = kwn_select(codes, k, n_codes)
        drive_exact = levels[codes.long()] * scale * maskf * gain
        in_ramp = ((mac_e >= -rng - 0.5) & (mac_e <= rng + 0.5)).float()
        drive_sur = mac * scale * gain * in_ramp
        drive = _ste(drive_exact, drive_sur)
        leak = kwn_relax * drive_sur
        v_lose = v + (leak - leak.detach())
        v_win = _ste(f32math.fma(beta, v.detach(), drive_exact),
                     beta * v + drive)
        v2 = torch.where(maskf > 0, v_win, v_lose)
        if snl:
            nz = kicks[t] if kicks is not None else amp * ctrprng.counter_sign(
                seed, t, rows, cols, ctrprng.TAG_SNL)
            vd = v2.detach()
            v2 = torch.where((vd > v_th2) & (vd < v_th1), v2 + nz, v2)
        v_clip = _SatClip.apply(v2)
        s = _Spike.apply(v_clip, v_th1)
        v = torch.where(s.detach() > 0, torch.full_like(v_clip, V_RESET),
                        v_clip)
        counts = counts + s
    logits = mm(f32math.div(counts, t_steps), params["w_out"], tf32)
    lse = torch.log_softmax(logits, dim=-1)
    return -lse.gather(1, labels[:, None].long()).mean()


def train_step(p: dict, m: dict, events: torch.Tensor,
               labels: torch.Tensor, seed: int, cfg: dict, lr: float,
               noise, kwn_relax: float, tf32: bool = False):
    """One step of SGD with momentum 0.9 (``m = 0.9 m + g``, ``p = p - lr
    m``) from the state (``p``, ``m``) on one batch with one counter
    seed.  Returns (loss, gradient, new p, new m), the last three dicts
    by leaf name."""
    leaf = {k: a.detach().requires_grad_(True) for k, a in p.items()}
    loss = train_loss(leaf, events, labels, cfg, seed, noise, kwn_relax,
                      tf32)
    names = list(leaf)
    grads = torch.autograd.grad(loss, [leaf[k] for k in names])
    g = {k: a.detach() for k, a in zip(names, grads)}
    with torch.no_grad():
        m = {k: 0.9 * m[k] + g[k] for k in names}
        p = {k: p[k].detach() - lr * m[k] for k in names}
    return float(loss.detach()), g, p, m


def train_steps(params: dict, batches, seeds, cfg: dict, lr: float,
                noise, kwn_relax: float, tf32: bool = False):
    """``train_step`` from ``params`` and a zero momentum over
    ``batches`` (a list of (events, labels)) with one counter seed each.
    Returns (losses, the gradients of the first step, the parameters
    after the last), each a dict by leaf name but the losses."""
    p = {k: a.detach().clone() for k, a in params.items()}
    m = {k: torch.zeros_like(a) for k, a in p.items()}
    losses, first = [], None
    for (ev, lab), seed in zip(batches, seeds):
        loss, g, p, m = train_step(p, m, ev, lab, seed, cfg, lr, noise,
                                   kwn_relax, tf32)
        if first is None:
            first = g
        losses.append(loss)
    return losses, first, p


def leaf_norm(a: torch.Tensor) -> float:
    return math.sqrt(float((a.double() ** 2).sum()))
