"""The paper's event SNN, served and trained through the macro.

Counterpart of ``repro.models.snn``: ``SNNConfig``, ``init_params``,
``forward_silicon`` in its three forms, through the fused kernels
(``fused="seq"``, one launch a sequence, or ``"step"``, one launch a time
step) or through the composed stage chain (``fused=False``: the ``core``
stage functions in plain PyTorch, no kernel, the bitwise oracle of the
fused forms), each in both modes (KWN and NLD) and for KWN layer stacks,
the streaming state behind the
continuous-batching engine (``forward_silicon_stream`` with save/restore
of one slot; single-layer KWN and NLD), and training: software BPTT
(``forward_train``) and silicon-in-the-loop training through the fused
kernel and its surrogate backward (``loss_fn(silicon=True)``, see
``train.silicon``), with ``train_step`` / ``train`` (SGD with momentum) and
``evaluate``.

JAX keys have no counterpart: the counter-PRNG seed word is an ``int``
(``seed``); the reference derives it from its key (``snn._noise_seed``).
A noisy stack takes one seed word per layer (``seeds``, the reference's
``snn._noise_seeds``), derived from ``seed`` when not given.  Batches and
step seeds come from explicit ``torch.Generator``s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import ctrprng, f32math
from repro_torch.core import dendrite as dendrite_lib
from repro_torch.core import ima as ima_lib
from repro_torch.core import kwn as kwn_lib
from repro_torch.core import lif as lif_lib
from repro_torch.core import macro as macro_lib
from repro_torch.core import prbs as prbs_lib
from repro_torch.core import ternary as ternary_lib
from repro_torch.obs import trace as obs_trace

_TAG_LAYER = 0x4C415952      # key lane of the derived per-layer seed words


@dataclasses.dataclass(frozen=True)
class SNNConfig:
    n_in: int
    n_hidden: int = 128           # the macro's 128 columns
    n_classes: int = 10
    n_steps: int = 20
    mode: str = "kwn"             # kwn | nld
    k: int = 12                   # KWN winners
    n_branches: int = 2           # NLD dendritic branches
    activation: str = "quadratic"  # NLD activation f()
    code_bits: int = 5
    mac_range: float = 24.0       # NLQ full scale, in integer MAC units
    dend_range: float = 4.0       # NLD branch-MAC full scale (float units)
    drive_gain: float = 0.25      # V_mem LSBs per unit drive
    beta: float = 0.9
    v_th1: float = 1.0
    v_th2: float = 0.6
    noise_amp: float = 0.05
    use_snl: bool = True
    train_nlq: bool = True        # NLQ-aware training (Fig. 6c)
    weight_qat: bool = True       # twin-cell 3-bit QAT
    # KWN layer stack: widths of L chained macro layers (n_hidden is forced
    # to the last width, which the readout reads) and per-layer winner
    # counts (default: k for every layer).
    hidden_layers: tuple[int, ...] | None = None
    k_layers: tuple[int, ...] | None = None

    def __post_init__(self):
        if self.mode not in ("kwn", "nld"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.hidden_layers is not None:
            hl = tuple(int(h) for h in self.hidden_layers)
            if not hl:
                raise ValueError("hidden_layers must be a non-empty tuple")
            if self.mode == "nld" and len(hl) > 1:
                raise ValueError("multi-layer stacks are KWN-only; the NLD "
                                 "stack is a roadmap follow-up")
            object.__setattr__(self, "hidden_layers", hl)
            object.__setattr__(self, "n_hidden", hl[-1])
        if self.k_layers is not None:
            kl = tuple(int(x) for x in self.k_layers)
            if len(kl) != len(self.layer_widths):
                raise ValueError(f"k_layers has {len(kl)} entries for "
                                 f"{len(self.layer_widths)} layers")
            object.__setattr__(self, "k_layers", kl)

    @property
    def layer_widths(self) -> tuple:
        """Hidden-layer widths, the last one feeding the readout."""
        return self.hidden_layers or (self.n_hidden,)

    @property
    def layer_k(self) -> tuple:
        """Per-layer KWN winner counts."""
        return self.k_layers or (self.k,) * len(self.layer_widths)


def _is_stack(cfg: SNNConfig) -> bool:
    return len(cfg.layer_widths) > 1


def init_params(cfg: SNNConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random weights from ``generator``, on ``device``: ``w_out``
    (n_hidden, n_classes) and either ``w_hid`` (n_in, n_hidden), a
    ``w_hid`` list (one (I_l, N_l) array per layer of a stack) or
    ``dend`` (NLD ``DendriteParams``)."""
    dev = device_lib.resolve(device)
    widths = cfg.layer_widths
    p = {}
    if cfg.mode == "nld":
        p["dend"] = dendrite_lib.dendrite_init(
            generator, cfg.n_in, cfg.n_hidden, cfg.n_branches, device=dev)
    else:
        fan_ins = (cfg.n_in,) + widths[:-1]
        w_hid = [(torch.randn((f_in, w), generator=generator)
                  / math.sqrt(f_in) * 3.0).to(dev)
                 for f_in, w in zip(fan_ins, widths)]
        p["w_hid"] = w_hid if _is_stack(cfg) else w_hid[0]
    p["w_out"] = (torch.randn((cfg.n_hidden, cfg.n_classes),
                              generator=generator)
                  / math.sqrt(cfg.n_hidden)).to(dev)
    return p


def params_to(p: dict, device) -> dict:
    """``p`` with every array (also inside ``dend`` and a ``w_hid`` list)
    as a tensor on ``device``."""
    def put(a):
        return torch.as_tensor(a).to(device)

    out = {}
    for name, w in p.items():
        if isinstance(w, dendrite_lib.DendriteParams):
            out[name] = dendrite_lib.DendriteParams(*(put(a) for a in w))
        elif isinstance(w, (list, tuple)):
            out[name] = [put(a) for a in w]
        else:
            out[name] = put(w)
    return out


def _macro_cfg(cfg: SNNConfig, noise) -> macro_lib.CIMMacroConfig:
    """The macro config; the ramp's full scale is ``dend_range`` in NLD
    mode (float branch-MAC units) and ``mac_range`` in KWN mode."""
    return macro_lib.CIMMacroConfig(
        code_bits=cfg.code_bits,
        mac_range=cfg.mac_range if cfg.mode == "kwn" else cfg.dend_range,
        ima_noise=noise)


def pack_fused(p: dict, cfg: SNNConfig, noise=None
               ) -> macro_lib.FusedMacroWeights:
    """The packed operands of a single-layer config: ``w_hid`` quantized
    onto the twin-cell grid (KWN), or the branch weights of ``dend``
    (NLD)."""
    mcfg = _macro_cfg(cfg, noise)
    if cfg.mode == "nld":
        return macro_lib.pack_nld_weights(p["dend"], mcfg,
                                          activation=cfg.activation)
    w_int, scale = ternary_lib.quantize_weights_3bit(p["w_hid"])
    return macro_lib.pack_kwn_weights(w_int, scale.reshape(-1), mcfg)


def pack_fused_stack(p: dict, cfg: SNNConfig, noise=None
                     ) -> list[macro_lib.FusedMacroWeights]:
    """The packed operands of every layer of a KWN stack."""
    if not isinstance(p["w_hid"], (list, tuple)) \
            or len(p["w_hid"]) != len(cfg.layer_widths):
        raise ValueError(f"a {len(cfg.layer_widths)}-layer stack needs a "
                         f"w_hid list with one array per layer")
    w_ints, scales = [], []
    for w in p["w_hid"]:
        w_int, scale = ternary_lib.quantize_weights_3bit(w)
        w_ints.append(w_int)
        scales.append(scale.reshape(-1))
    return macro_lib.pack_kwn_stack(w_ints, scales, _macro_cfg(cfg, noise))


def layer_seeds(seed: int, n_layers: int) -> list[int]:
    """Distinct per-layer counter seed words derived from ``seed``
    (Threefry of (seed, layer tag) at counter (layer, 0))."""
    out = []
    for li in range(n_layers):
        word, _ = ctrprng.threefry2x32(int(seed), _TAG_LAYER, li, 0)
        out.append(int(word) & 0x7FFFFFFF)
    return out


def _lif(cfg: SNNConfig, use_snl: bool | None = None) -> dict:
    return dict(drive_gain=cfg.drive_gain, beta=cfg.beta, v_th1=cfg.v_th1,
                v_th2=cfg.v_th2, v_reset=lif_lib.LIFParams().v_reset,
                v_lim=lif_lib.vmem_limit(lif_lib.LIFParams().vmem_bits),
                use_snl=cfg.use_snl if use_snl is None else use_snl)


def _skip_ratio(occupied: torch.Tensor, blocks: int) -> torch.Tensor:
    """``clip(1 - occupied / blocks, 0, 1)`` in f32: an exact integer sum
    divided by the block count (the reference's ``jnp.mean``)."""
    frac = f32math.div(occupied.float().sum(), blocks)
    return torch.clamp(1.0 - frac, 0.0, 1.0)


def forward_silicon(p: dict, events, cfg: SNNConfig, seed: int = 0,
                    mode: str | None = None, k: int | None = None,
                    use_snl: bool | None = None,
                    noise: ima_lib.IMANoiseModel | None = None,
                    fused: bool | str = "seq", mac_telemetry: bool = False,
                    device=None, seeds=None):
    """Inference through the macro: events (B, T, N_in) -> (logits (B,
    classes), telemetry).

    ``fused=False`` runs the composed stage chain (``_forward_silicon_
    composed``): the ``core`` stage functions a time step at a time in
    plain PyTorch, no kernel, the reference's bitwise oracle for the fused
    paths (clean KWN equals ``"seq"`` and ``"step"`` bit for bit).
    ``fused="seq"`` (or True) runs the whole sequence in one kernel
    launch: the KWN head (Eq. 1), the NLD head (Eq. 2, ``cfg.mode ==
    "nld"``) or, with ``cfg.hidden_layers``, the stacked KWN kernel.
    ``fused="step"`` launches the same single-layer kernel once per time
    step (the T=1 case), threading the membrane and the PRBS state, with
    the step index as the counter step word, so that its outputs equal the
    sequence path's bit for bit; a stack routes ``"step"`` to the stacked
    kernel as the reference does.  Clean KWN, the SNL noise is the
    PRBS-15 stream drawn ``B * width`` bits per step from one LFSR per
    layer; with ``noise`` (the Fig. 7 ``IMANoiseModel``) both the IMA
    error and the SNL sign noise come from the counter PRNG keyed on
    ``seed`` (a stack on ``seeds``, one word per layer, derived from
    ``seed`` when omitted).  The NLD head has no SNL noise.  Telemetry:
    per-request means over the actual sequence length of ADC steps, LIF
    updates and SOPs, plus the activity plan's skipped-block ratio.

    Per-call overrides, with the reference's meaning: ``mode or
    cfg.mode`` (the call runs on ``cfg`` with that mode: ``p`` needs
    ``w_hid`` for KWN and ``dend`` for NLD; a stack is KWN only, and
    another mode raises ``ValueError``), ``k or cfg.k`` (so 0 means
    ``cfg.k``; a stack without ``cfg.k_layers`` runs ``k`` in every
    layer) and ``cfg.use_snl`` where ``use_snl`` is None.  With
    ``use_snl=False`` no SNL stream (PRBS or counter) reaches the LIF.
    ``mac_telemetry=True`` has the single-layer kernels write their MAC
    stack, which is dropped, as the reference drops it: logits and
    telemetry are the same; a stack's kernel writes none, and ``"seq"`` /
    ``"step"`` on a stack raise ``ValueError``.

    The parameters are the reference's, in its order, with the int
    ``seed`` in the place of its PRNG ``key``; ``device`` and ``seeds``
    come after them.  The default differs from the reference's:
    ``fused="seq"`` here (the port's main path, the kernels),
    ``fused=False`` there (the composed chain).  Clean KWN gives the same
    bits either way; NLD does not (the kernel puts the branch weights on
    the twin-cell grid and draws the Fig. 7 noise inside it), nor do noisy
    results (another stream).  To compute what a reference caller that
    leaves ``fused`` out computes, pass ``fused=False``.
    """
    if fused not in (False, True, "seq", "step"):
        raise ValueError(f"unknown fused={fused!r}; expected False, True, "
                         f"'step' or 'seq'")
    mode = mode or cfg.mode
    if _is_stack(cfg) and mode != "kwn":
        raise ValueError("multi-layer stacks are KWN-only")
    if _is_stack(cfg) and mac_telemetry and fused is not False:
        raise ValueError("mac_telemetry is single-layer only: the stacked "
                         "kernel never writes MACs to HBM")
    if mode != cfg.mode:
        cfg = dataclasses.replace(cfg, mode=mode)
    k = k or cfg.k
    use_snl = cfg.use_snl if use_snl is None else bool(use_snl)
    dev = device_lib.resolve(device)
    ev = torch.as_tensor(events).to(dev, torch.float32)
    p = params_to(p, dev)
    ks = cfg.k_layers or (k,) * len(cfg.layer_widths)
    if fused is False:
        if _is_stack(cfg):
            return _forward_silicon_composed_stack(p, ev, cfg, seed, noise,
                                                   ks, use_snl)
        return _forward_silicon_composed(p, ev, cfg, seed, noise, k,
                                         use_snl)
    if _is_stack(cfg):
        return _forward_silicon_stack(p, ev, cfg, seed, noise, seeds, ks,
                                      use_snl)
    b, t_steps = ev.shape[0], ev.shape[1]
    fw = pack_fused(p, cfg, noise)
    noisy = noise is not None
    snl_active = use_snl and cfg.mode == "kwn"
    noise_amp = cfg.noise_amp if snl_active else 0.0
    ima_kn = macro_lib.fused_kernel_noise(fw, _macro_cfg(cfg, noise))
    ev_t = ev.transpose(0, 1)                              # (T, B, N_in)
    activity = macro_lib.plan_activity(ev_t, fw, cfg.n_hidden)
    v0 = lif_lib.lif_init((b, cfg.n_hidden), device=dev).v_mem
    prbs_amp = noise_amp if snl_active and not noisy else None
    lif = dict(_lif(cfg), use_snl=snl_active, k=k, ima_noise=ima_kn,
               snl_amp=noise_amp if noisy else 0.0,
               mac_telemetry=mac_telemetry, seed=int(seed) if noisy else 0)
    if fused == "step":
        spk_t, steps_t = _forward_steps(ev_t, fw, v0, lif, prbs_amp)
    else:
        noise_t = None          # counter streams, or no SNL at all
        if prbs_amp is not None:
            noise_t = prbs_lib.sequence_noise(b, t_steps, cfg.n_hidden,
                                              prbs_amp, dev)
        _, spk_t, _, steps_t, _ = macro_lib.fused_seq(
            ev_t, fw, v0, noise_t, activity=activity, **lif)
    counts = spk_t.sum(0)
    logits = f32math.div(counts, t_steps) @ p["w_out"]
    sops_t = ev_t.abs().sum(-1) * cfg.n_hidden             # (T, B)
    n_upd = float(k if cfg.mode == "kwn" else cfg.n_hidden)
    tele = {
        "adc_steps": f32math.div(steps_t.float().sum(0), t_steps),
        "lif_updates": torch.full((b,), n_upd, device=dev),
        "sops": f32math.div(sops_t.sum(0), t_steps),
        "skipped_block_ratio": torch.full(
            (b,), float(_skip_ratio(activity, activity.numel())),
            device=dev),
    }
    return logits, tele


def _forward_steps(ev_t, fw, v, lif: dict, prbs_amp: float | None):
    """One fused launch per time step, the membrane carried from launch to
    launch.  With ``prbs_amp`` (clean KWN with SNL) the SNL noise is
    ``B * N`` bits per step from one LFSR whose state is threaded step by
    step; otherwise the counter streams, keyed on the step index, or no
    SNL.  Returns the (T, B, N) spike and (T, B) ADC-step stacks."""
    b, n = v.shape
    prbs = torch.tensor([prbs_lib.lfsr_init(1)], device=v.device)
    spikes, steps = [], []
    for t in range(ev_t.shape[0]):
        nz = None
        if prbs_amp is not None:
            prbs, bits = prbs_lib.draw(prbs, b * n)
            nz = prbs_lib.bits_to_noise(bits[0], prbs_amp).reshape(b, n)
        v, spk, _, st, _ = macro_lib.fused_step(ev_t[t], fw, v, nz,
                                                step_offset=t, **lif)
        spikes.append(spk)
        steps.append(st)
    return torch.stack(spikes), torch.stack(steps)


def _forward_silicon_stack(p, ev, cfg: SNNConfig, seed, noise, seeds, ks,
                           use_snl: bool):
    """A KWN layer stack in one call of the stacked kernel: layer by layer,
    a parallel head and a LIF recurrence across T, the inter-layer spikes
    in a scratch the kernel's wrapper allocates; ``ks`` the per-layer
    winner counts.  Hidden layers report through telemetry only: SOPs
    from the per-layer spike counts, the skipped-block ratio from the
    per-layer occupancy counters."""
    dev = ev.device
    b, t_steps = ev.shape[0], ev.shape[1]
    widths = cfg.layer_widths
    n_layers = len(widths)
    stack = pack_fused_stack(p, cfg, noise)
    noisy = noise is not None
    noise_amp = cfg.noise_amp if use_snl else 0.0
    ima_kn = macro_lib.fused_kernel_noise(stack[0], _macro_cfg(cfg, noise))
    if noisy:
        seeds = layer_seeds(seed, n_layers) if seeds is None \
            else [int(s) for s in seeds]
        noises = None
    else:
        seeds = [0] * n_layers
        noises = [prbs_lib.sequence_noise(b, t_steps, w, noise_amp, dev)
                  if use_snl
                  else torch.zeros((t_steps, b, w), device=dev)
                  for w in widths]
    if len(seeds) != n_layers:
        raise ValueError(f"{len(seeds)} seeds for {n_layers} layers")
    ev_t = ev.transpose(0, 1)                              # (T, B, N_in)
    v0s = [lif_lib.lif_init((b, w), device=dev).v_mem for w in widths]
    out = macro_lib.fused_multi_seq(
        ev_t, stack, v0s, noises, ks=tuple(ks), **_lif(cfg, use_snl),
        ima_noise=ima_kn, snl_amp=noise_amp if noisy else 0.0, seeds=seeds)
    counts = out.spikes.sum(0)
    logits = f32math.div(counts, t_steps) @ p["w_out"]
    adc = sum(s.float().sum(0) for s in out.steps)
    sops = ternary_lib.ternary_input_encode(ev_t).abs().sum(-1).sum(0) \
        * widths[0]
    for li in range(1, n_layers):
        sops = sops + out.spike_counts[li - 1].sum(0) * widths[li]
    occupied = sum(o.sum() for o in out.occupancy)
    tele = {
        "adc_steps": f32math.div(adc, t_steps),
        "lif_updates": torch.full((b,), float(sum(ks)), device=dev),
        "sops": f32math.div(sops, t_steps),
        "skipped_block_ratio": torch.full(
            (b,), float(_skip_ratio(occupied, out.total_blocks)),
            device=dev),
    }
    return logits, tele


def nlq_steps_full(cfg: SNNConfig) -> int:
    """The full ramp's step count (NLD converts every column)."""
    return 2 ** cfg.code_bits - 1


def _composed_setup(ev, cfg: SNNConfig, seed, noise, use_snl: bool):
    """The composed path's LIF parameters and its noise generator: a
    ``torch.Generator`` on the events' device seeded from ``seed``, or None
    on the clean path (the reference splits its key per step)."""
    lif_p = lif_lib.LIFParams(beta=cfg.beta, v_th1=cfg.v_th1,
                              v_th2=cfg.v_th2,
                              noise_amp=cfg.noise_amp if use_snl else 0.0)
    gen = None
    if noise is not None:
        gen = torch.Generator(device=ev.device).manual_seed(int(seed))
    return lif_p, gen


def _kwn_composed_layer(cur, w_int, scale, k, nlq, mcfg, gen, noise):
    """One KWN layer for one step: ``cim_mac``, the NLQ ramp (with the
    Fig. 7 error drawn from ``gen`` when noisy), ``kwn_select`` on the
    quantized MAC, and the winner drive ``recon * scale * mask``."""
    mac_int = macro_lib.cim_mac(cur, w_int, mcfg, generator=gen)
    if noise is not None:
        codes = ima_lib.ima_convert_noisy(mac_int, nlq, gen, noise)
        mac_q = ima_lib.ima_reconstruct(codes, nlq)
    else:
        mac_q = ima_lib.ima_quantize(mac_int, nlq)
    res = kwn_lib.kwn_select(mac_q, k, nlq)
    return (mac_q * scale[0]) * res.mask, res


def _composed_tele(adc, upd, sops, t_steps: int) -> dict:
    return {"adc_steps": f32math.div(adc, t_steps),
            "lif_updates": f32math.div(upd, t_steps),
            "sops": f32math.div(sops, t_steps)}


def _forward_silicon_composed(p, ev, cfg: SNNConfig, seed, noise, k: int,
                              use_snl: bool):
    """The composed stage chain, a time step at a time (the reference's
    ``forward_silicon(fused=False)``): KWN ``cim_mac`` -> NLQ ramp (+ the
    Fig. 7 error from the generator) -> ``kwn_select`` -> ``lif_step``
    with the PRBS SNL noise threaded from one LFSR; NLD ``nld_forward``
    (float branch weights through the activation ramp, soma combine) ->
    the dense ``lif_step``.  Telemetry: per-step means of ADC steps, LIF
    updates and SOPs over ``events.shape[1]``; no skipped-block ratio."""
    dev = ev.device
    b, t_steps = ev.shape[0], ev.shape[1]
    n = cfg.n_hidden
    mcfg = _macro_cfg(cfg, noise)
    lif_p, gen = _composed_setup(ev, cfg, seed, noise, use_snl)
    if cfg.mode == "kwn":
        w_int, scale = ternary_lib.quantize_weights_3bit(p["w_hid"])
        nlq = _nlq_cb(cfg).to(dev)
    state = lif_lib.lif_init((b, n), device=dev)
    counts = torch.zeros((b, n), device=dev)
    adc, upd, sops = (torch.zeros((b,), device=dev) for _ in range(3))
    for t in range(t_steps):
        ev_t = ev[:, t]
        if cfg.mode == "nld":
            drive = macro_lib.nld_forward(ev_t, p["dend"], mcfg,
                                          activation=cfg.activation)
            mask, n_upd, steps = None, n, nlq_steps_full(cfg)
        else:
            drive, res = _kwn_composed_layer(ev_t, w_int, scale, k, nlq,
                                             mcfg, gen, noise)
            mask, n_upd, steps = res.mask, k, res.adc_steps.float()
        state, s = lif_lib.lif_step(state, drive * cfg.drive_gain, lif_p,
                                    update_mask=mask,
                                    use_snl=use_snl and cfg.mode == "kwn")
        counts = counts + s
        adc = adc + steps
        upd = upd + float(n_upd)
        sops = sops + ev_t.abs().sum(-1) * n
    logits = f32math.div(counts, t_steps) @ p["w_out"]
    return logits, _composed_tele(adc, upd, sops, t_steps)


def _forward_silicon_composed_stack(p, ev, cfg: SNNConfig, seed, noise, ks,
                                    use_snl: bool):
    """The composed chain through a KWN layer stack, layer after layer in
    each time step, every inter-layer spike tensor materialized (the
    reference's ``_forward_silicon_composed_multi``).  Each layer's LIF has
    its own LFSR; a noisy stack draws one normal tensor per step and layer
    from the generator, in layer order (the reference folds the layer into
    the step key)."""
    dev = ev.device
    b, t_steps = ev.shape[0], ev.shape[1]
    widths = cfg.layer_widths
    mcfg = _macro_cfg(cfg, noise)
    lif_p, gen = _composed_setup(ev, cfg, seed, noise, use_snl)
    layers = [ternary_lib.quantize_weights_3bit(w) for w in p["w_hid"]]
    nlq = _nlq_cb(cfg).to(dev)
    states = [lif_lib.lif_init((b, w), device=dev) for w in widths]
    counts = torch.zeros((b, cfg.n_hidden), device=dev)
    adc, upd, sops = (torch.zeros((b,), device=dev) for _ in range(3))
    for t in range(t_steps):
        cur = ev[:, t]
        adc_t = torch.zeros((b,), device=dev)
        sops_t = torch.zeros((b,), device=dev)
        for li, (w_int, scale) in enumerate(layers):
            drive, res = _kwn_composed_layer(cur, w_int, scale, ks[li], nlq,
                                             mcfg, gen, noise)
            states[li], s = lif_lib.lif_step(
                states[li], drive * cfg.drive_gain, lif_p,
                update_mask=res.mask, use_snl=use_snl)
            adc_t = adc_t + res.adc_steps.float()
            sops_t = sops_t + cur.abs().sum(-1) * widths[li]
            cur = s
        counts = counts + cur
        adc = adc + adc_t
        upd = upd + float(sum(ks))
        sops = sops + sops_t
    logits = f32math.div(counts, t_steps) @ p["w_out"]
    return logits, _composed_tele(adc, upd, sops, t_steps)


class SiliconStreamState(NamedTuple):
    """Per-slot state of step-resumable fused inference (one row per slot):
    the SNN analog of an LM engine's KV cache."""

    v: torch.Tensor           # (S, N) f32 LIF membrane
    prbs: torch.Tensor        # (S,) int64 per-slot PRBS LFSR state
    counts: torch.Tensor      # (S, N) f32 spike-count accumulator
    adc: torch.Tensor         # (S,) f32 summed early-stop ADC ramp steps
    sops: torch.Tensor        # (S,) f32 summed synaptic operations
    skip_acc: torch.Tensor    # (S,) f32 summed per-step skipped-block ratio
    steps_done: torch.Tensor  # (S,) int32 time steps completed
    length: torch.Tensor      # (S,) int32 request sequence length
    seed: torch.Tensor        # (S,) int32 per-request counter-PRNG seed


def silicon_stream_init(cfg: SNNConfig, slots: int,
                        device=None) -> SiliconStreamState:
    """All-idle slot state on ``device``."""
    dev = device_lib.resolve(device)
    n = cfg.n_hidden
    zf = torch.zeros((slots,), dtype=torch.float32, device=dev)
    zi = torch.zeros((slots,), dtype=torch.int32, device=dev)
    return SiliconStreamState(
        v=torch.zeros((slots, n), dtype=torch.float32, device=dev),
        prbs=torch.full((slots,), prbs_lib.lfsr_init(1), dtype=torch.int64,
                        device=dev),
        counts=torch.zeros((slots, n), dtype=torch.float32, device=dev),
        adc=zf, sops=zf.clone(), skip_acc=zf.clone(), steps_done=zi,
        length=zi.clone(), seed=zi.clone())


def silicon_stream_admit(state: SiliconStreamState, mask, lengths,
                         seeds) -> SiliconStreamState:
    """Reset the masked slots to the one-shot starting point and set every
    slot's length and seed from the full (S,) vectors."""
    dev = state.v.device
    m = torch.as_tensor(np.asarray(mask), dtype=torch.bool, device=dev)
    m1 = m[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return SiliconStreamState(
        v=torch.where(m1, zero, state.v),
        prbs=torch.where(m, torch.full_like(state.prbs,
                                            prbs_lib.lfsr_init(1)),
                         state.prbs),
        counts=torch.where(m1, zero, state.counts),
        adc=torch.where(m, zero, state.adc),
        sops=torch.where(m, zero, state.sops),
        skip_acc=torch.where(m, zero, state.skip_acc),
        steps_done=torch.where(m, torch.zeros_like(state.steps_done),
                               state.steps_done),
        length=torch.as_tensor(np.asarray(lengths), dtype=torch.int32,
                               device=dev),
        seed=torch.as_tensor(np.asarray(seeds), dtype=torch.int32,
                             device=dev))


class SlotCheckpoint(NamedTuple):
    """Host snapshot of one slot: everything a preempted request needs to
    resume bit for bit, in any free slot (the noise keying never sees the
    physical slot index)."""

    v: np.ndarray          # (N,) f32 LIF membrane at the preemption point
    prbs: int              # PRBS LFSR word (clean-path SNL stream)
    counts: np.ndarray     # (N,) f32 spike-count accumulator
    adc: float             # summed early-stop ADC ramp steps so far
    sops: float            # summed synaptic operations so far
    skip_acc: float        # summed per-step skipped-block ratio so far
    steps_done: int        # absolute stream offset to resume at
    length: int            # request sequence length
    seed: int              # per-request counter-PRNG seed word


def checkpoint_nbytes(ckpt: SlotCheckpoint) -> int:
    """Payload bytes of one slot checkpoint (arrays + one word a scalar)."""
    scalar_bytes = 8 * (len(ckpt) - 2)
    return int(ckpt.v.nbytes + ckpt.counts.nbytes + scalar_bytes)


def silicon_stream_save(state: SiliconStreamState,
                        slot: int) -> SlotCheckpoint:
    """Checkpoint slot ``slot`` to host memory (device state untouched);
    a ``checkpoint_save`` span on the ``transfer`` track."""
    tr = obs_trace.get_tracer()
    span = tr.begin("checkpoint_save", track="transfer")
    ckpt = SlotCheckpoint(
        v=state.v[slot].cpu().numpy().copy(),
        prbs=int(state.prbs[slot]),
        counts=state.counts[slot].cpu().numpy().copy(),
        adc=float(state.adc[slot]),
        sops=float(state.sops[slot]),
        skip_acc=float(state.skip_acc[slot]),
        steps_done=int(state.steps_done[slot]),
        length=int(state.length[slot]),
        seed=int(state.seed[slot]))
    if span is not None:
        tr.end(span, args={"slot": int(slot),
                           "bytes": checkpoint_nbytes(ckpt),
                           "direction": "device_to_host"})
    return ckpt


def silicon_stream_restore(state: SiliconStreamState, slot: int,
                           ckpt: SlotCheckpoint) -> SiliconStreamState:
    """Write a ``SlotCheckpoint`` into slot ``slot`` (any free slot); a
    ``checkpoint_restore`` span on the ``transfer`` track."""
    tr = obs_trace.get_tracer()
    span = tr.begin("checkpoint_restore", track="transfer")
    dev = state.v.device

    def put(a, value, dtype):
        a = a.clone()
        a[slot] = torch.as_tensor(value, dtype=dtype).to(dev)
        return a

    f32, i32 = torch.float32, torch.int32
    state = SiliconStreamState(
        v=put(state.v, ckpt.v, f32), prbs=put(state.prbs, ckpt.prbs,
                                              torch.int64),
        counts=put(state.counts, ckpt.counts, f32),
        adc=put(state.adc, ckpt.adc, f32), sops=put(state.sops, ckpt.sops,
                                                    f32),
        skip_acc=put(state.skip_acc, ckpt.skip_acc, f32),
        steps_done=put(state.steps_done, ckpt.steps_done, i32),
        length=put(state.length, ckpt.length, i32),
        seed=put(state.seed, ckpt.seed, i32))
    if span is not None:
        tr.end(span, args={"slot": int(slot),
                           "bytes": checkpoint_nbytes(ckpt),
                           "direction": "host_to_device"})
    return state


def forward_silicon_stream(p: dict, events: torch.Tensor, cfg: SNNConfig,
                           state: SiliconStreamState,
                           noise: ima_lib.IMANoiseModel | None = None,
                           fw: macro_lib.FusedMacroWeights | None = None
                           ) -> SiliconStreamState:
    """One continuous-batching round: advance every slot by R steps.

    ``events`` is the time-major (R, S, N_in) round block on the state's
    device; slot s carries steps ``[steps_done[s], steps_done[s] + R)`` of
    its request, zero past its end.  One kernel launch; each slot replays
    the noise of its own batch-1 run (counter PRNG via ``row_ctl`` keyed
    on its seed, absolute step and row 0; clean SNL from its own LFSR), so
    a request's results equal a one-shot batch-1 ``forward_silicon`` bit
    for bit.  The NLD head has no SNL, so its slots draw no PRBS bits.
    ``fw`` is the packed weights (``pack_fused``), packed here when
    omitted.  Single-layer configs only: the engine serves stacks through
    its drain path.
    """
    if _is_stack(cfg):
        raise ValueError("forward_silicon_stream is single-layer only; "
                         "serve stacks through the legacy drain path")
    dev = state.v.device
    if fw is None:
        fw = pack_fused(params_to(p, dev), cfg, noise)
    noisy = noise is not None
    snl_active = cfg.use_snl and cfg.mode == "kwn"
    noise_amp = cfg.noise_amp if snl_active else 0.0
    ima_kn = macro_lib.fused_kernel_noise(fw, _macro_cfg(cfg, noise))
    events = events.to(dev, torch.float32)
    r, slots = events.shape[0], events.shape[1]
    activity = macro_lib.plan_activity(events, fw, cfg.n_hidden)
    new_prbs = state.prbs
    if noisy or cfg.mode == "nld":
        noise_t = None
    elif snl_active:
        new_prbs, bits = prbs_lib.draw(state.prbs, r * cfg.n_hidden)
        noise_t = prbs_lib.bits_to_noise(bits, noise_amp).reshape(
            slots, r, cfg.n_hidden).transpose(0, 1)
    else:
        noise_t = torch.zeros((r, slots, cfg.n_hidden), device=dev)
    row_ctl = macro_lib.stream_row_ctl(state.seed, state.steps_done)
    v_out, spk_t, _, steps_t, _ = macro_lib.fused_seq(
        events, fw, state.v, noise_t, k=cfg.k,
        **dict(_lif(cfg), use_snl=snl_active), ima_noise=ima_kn,
        snl_amp=noise_amp if noisy else 0.0, activity=activity,
        mac_telemetry=False, row_ctl=row_ctl)
    iota = torch.arange(r, dtype=torch.int32, device=dev)[:, None]
    af = ((state.steps_done[None, :] + iota)
          < state.length[None, :]).float()                 # (R, S)
    counts = state.counts + (spk_t * af[:, :, None]).sum(0)
    adc = state.adc + (steps_t.float() * af).sum(0)
    sops = state.sops + (events.abs().sum(-1) * af).sum(0) * cfg.n_hidden
    ratio = _skip_ratio(activity, activity.numel())
    skip_acc = state.skip_acc + ratio * af.sum(0)
    steps_done = torch.minimum(state.steps_done + r, state.length)
    return SiliconStreamState(v=v_out, prbs=new_prbs, counts=counts,
                              adc=adc, sops=sops, skip_acc=skip_acc,
                              steps_done=steps_done, length=state.length,
                              seed=state.seed)


# --- training ----------------------------------------------------------------

def _nlq_cb(cfg: SNNConfig) -> ima_lib.RampCodebook:
    return ima_lib.nlq_codebook(cfg.code_bits, -cfg.mac_range, cfg.mac_range)


def _act_cb(cfg: SNNConfig) -> ima_lib.RampCodebook:
    return ima_lib.activation_codebook(
        cfg.code_bits, ima_lib.DENDRITE_ACTIVATIONS[cfg.activation],
        -cfg.dend_range, cfg.dend_range)


def _kwn_drive_train(w_full, spikes, cfg: SNNConfig, nlq):
    """One KWN layer's QAT / STE MAC drive for one time step: the MAC
    through the twin-cell fake quantizer, then (``train_nlq``) through the
    NLQ ramp in integer MAC units (divided by the per-column scale before
    the ramp, multiplied back after)."""
    w = ternary_lib.quantize_weights_ste(w_full) if cfg.weight_qat \
        else w_full
    mac = spikes @ w
    if cfg.train_nlq:
        scale = ternary_lib.quantize_weights_3bit(w_full)[1][0].detach()
        mac = ima_lib.ima_quantize_ste(f32math.div(mac, scale), nlq) * scale
    return mac


def forward_train(p: dict, events: torch.Tensor,
                  cfg: SNNConfig) -> torch.Tensor:
    """Software BPTT forward on ``events``' device: events (B, T, N_in) ->
    logits (B, classes).

    Dense LIF updates (top-K masking belongs to inference), the twin-cell
    and NLQ fake quantizers (``weight_qat``, ``train_nlq``), the SuperSpike
    surrogate at the spike.  NLD drives through ``dendrite_mac`` (the
    quantized activation ramp with ``f'`` as its gradient when
    ``train_nlq``); a KWN stack chains spike -> MAC -> LIF -> spike per
    step and reads out the last layer.  Spike counts are normalized by the
    actual sequence length.
    """
    b, t_steps = events.shape[0], events.shape[1]
    dev = events.device
    widths = cfg.layer_widths if cfg.mode == "kwn" else (cfg.n_hidden,)
    if cfg.mode == "nld":
        f = dendrite_lib.TRAIN_ACTIVATIONS[cfg.activation]
        cb = _act_cb(cfg) if cfg.train_nlq else None
        w_hid = [None]

        def drive_of(li, x):
            return dendrite_lib.dendrite_mac(p["dend"], x, f, cb,
                                             quantize=cb is not None)
    else:
        nlq = _nlq_cb(cfg)
        w_hid = p["w_hid"] if _is_stack(cfg) else [p["w_hid"]]

        def drive_of(li, x):
            return _kwn_drive_train(w_hid[li], x, cfg, nlq)
    vs = [torch.zeros((b, w), device=dev) for w in widths]
    counts = torch.zeros((b, cfg.n_hidden), device=dev)
    for t in range(t_steps):
        cur = events[:, t]
        for li in range(len(widths)):
            v = cfg.beta * vs[li] + drive_of(li, cur) * cfg.drive_gain
            cur = lif_lib.spike_fn(v, cfg.v_th1)
            vs[li] = torch.where(cur > 0, torch.zeros_like(v), v)
        counts = counts + cur
    return f32math.div(counts, t_steps) @ p["w_out"]


def loss_fn(p: dict, events: torch.Tensor, labels: torch.Tensor,
            cfg: SNNConfig, seed: int | None = None, *,
            silicon: bool = False,
            noise: ima_lib.IMANoiseModel | None = None,
            kwn_relax: float | None = None,
            remat: bool = False) -> torch.Tensor:
    """Cross-entropy loss.  ``silicon=True`` differentiates through the
    fused macro kernel and its surrogate backward (``train.silicon``;
    ``seed`` keys its counter noise, ``noise`` makes it noise-aware QAT)
    instead of the software path ``forward_train``."""
    if silicon:
        from repro_torch.train import silicon as silicon_lib
        return silicon_lib.loss_fn(
            p, events, labels, cfg, 0 if seed is None else int(seed),
            noise=noise, remat=remat,
            kwn_relax=silicon_lib.DEFAULT_KWN_RELAX if kwn_relax is None
            else kwn_relax)
    logits = forward_train(p, events, cfg)
    lse = torch.log_softmax(logits, dim=-1)
    return -lse.gather(1, labels[:, None].long()).mean()


def _tree_map(fn, *trees: dict) -> dict:
    """``fn`` over the tensors of params-shaped dicts (a ``w_hid`` list and
    the fields of ``dend`` included)."""
    out = {}
    for name, w in trees[0].items():
        parts = [t[name] for t in trees]
        if isinstance(w, dendrite_lib.DendriteParams):
            out[name] = dendrite_lib.DendriteParams(
                *(fn(*xs) for xs in zip(*parts)))
        elif isinstance(w, (list, tuple)):
            out[name] = [fn(*xs) for xs in zip(*parts)]
        else:
            out[name] = fn(*parts)
    return out


def _tree_leaves(tree: dict) -> list:
    leaves = []
    _tree_map(leaves.append, tree)
    return leaves


def train_step(p: dict, opt_m: dict, events: torch.Tensor,
               labels: torch.Tensor, cfg: SNNConfig, lr: float,
               seed: int | None = None, *, silicon: bool = False,
               noise=None, kwn_relax: float | None = None,
               remat: bool = False):
    """One SGD-with-momentum step: ``m = 0.9 m + g``, ``p = p - lr m`` on
    every tensor of ``p`` (``dend.mask`` too, as in the reference).
    Returns (p, opt_m, loss), the loss a device scalar."""
    leaf_p = _tree_map(lambda a: a.detach().requires_grad_(True), p)
    loss = loss_fn(leaf_p, events, labels, cfg, seed, silicon=silicon,
                   noise=noise, kwn_relax=kwn_relax, remat=remat)
    leaves = _tree_leaves(leaf_p)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(a) if g is None else g
               for a, g in zip(leaves, grads)])
    g = _tree_map(lambda _: next(it), leaf_p)
    with torch.no_grad():
        opt_m = _tree_map(lambda m, gg: 0.9 * m + gg, opt_m, g)
        p = _tree_map(lambda a, m: a.detach() - lr * m, p, opt_m)
    return p, opt_m, loss.detach()


def train_generators(seed: int, device) -> tuple[torch.Generator,
                                                 torch.Generator]:
    """The two generators ``train`` draws from for ``seed``: batches, on
    the dataset's ``device``, and the silicon step seeds, on the CPU.  The
    step seeds have their own stream, so a silicon run draws the same
    batches as a software run of the same seed."""
    batches = torch.Generator(device=device).manual_seed(int(seed))
    steps = torch.Generator().manual_seed(int(seed) ^ 0x5EED5EED)
    return batches, steps


def train(cfg: SNNConfig, dataset, n_steps: int = 300, batch: int = 64,
          seed: int = 0, lr: float = 0.05, *, silicon: bool = False,
          noise: ima_lib.IMANoiseModel | None = None,
          kwn_relax: float | None = None, remat: bool = False,
          params: dict | None = None, device=None):
    """SGD with momentum on ``device`` (default ``cuda``).

    Batches come from ``dataset.sample`` with the batch generator of
    ``train_generators(seed)``; parameters from ``init_params`` with a CPU
    generator seeded ``seed``, or a copy of ``params`` (warm start: the
    software pre-train -> silicon fine-tune recipe).  ``silicon=True``
    trains through the fused kernel and its surrogate backward (KWN
    single layer); every step then draws a fresh counter seed from the
    step-seed generator, so with ``noise`` each step sees a fresh silicon
    noise instance.  Losses stay on the device until the end.  Returns
    (params, losses as floats).
    """
    dev = device_lib.resolve(device)
    if params is None:
        p = init_params(cfg, torch.Generator().manual_seed(int(seed)), dev)
    else:
        p = _tree_map(lambda a: a.detach().clone(), params_to(params, dev))
    opt_m = _tree_map(torch.zeros_like, p)
    batches, step_seeds = train_generators(seed, dataset.device)
    losses = []
    for _ in range(n_steps):
        ev, lab = dataset.sample(batches, batch)
        step = None
        if silicon:
            from repro_torch.train import silicon as silicon_lib
            step = silicon_lib.step_seed(step_seeds)
        p, opt_m, loss = train_step(p, opt_m, ev.to(dev), lab.to(dev), cfg,
                                    lr, step, silicon=silicon, noise=noise,
                                    kwn_relax=kwn_relax, remat=remat)
        losses.append(loss)
    return p, [float(x) for x in torch.stack(losses).cpu()] if losses \
        else []


def evaluate(p: dict, cfg: SNNConfig, dataset, generator: torch.Generator,
             n_batches: int = 10, batch: int = 128, **silicon_kwargs):
    """Accuracy and mean telemetry of ``forward_silicon`` over
    ``n_batches`` batches drawn from ``generator`` (on the dataset's
    device), which also draws each batch's counter seed.  Without a
    ``fused`` among ``silicon_kwargs`` this is the port's default path,
    ``fused="seq"``, where the reference's ``evaluate`` runs the
    composed chain (``fused=False``): pass ``fused=False`` for the
    reference's NLD and noisy results."""
    accs, teles = [], []
    for _ in range(n_batches):
        ev, lab = dataset.sample(generator, batch)
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator,
                                 device=generator.device))
        logits, tele = forward_silicon(p, ev, cfg, seed=seed,
                                       **silicon_kwargs)
        accs.append(float((logits.argmax(-1) == lab.to(logits.device))
                          .float().mean()))
        teles.append(tele)
    tele = {k: float(torch.stack([t[k].float().mean() for t in teles])
                     .mean()) for k in teles[0]}
    return sum(accs) / len(accs), tele
