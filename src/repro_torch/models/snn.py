"""The paper's event SNN served through the fused macro kernel.

Counterpart of ``repro.models.snn`` for single-layer KWN inference:
``SNNConfig``, ``init_params``, ``forward_silicon(fused="seq")`` and the
streaming state behind the continuous-batching engine
(``forward_silicon_stream`` with save/restore of one slot).  Training, the
composed and per-step paths and NLD mode belong to later slices of the
port and raise ``NotImplementedError``; layer stacks come with the
multi-layer slice.

JAX keys have no counterpart: the counter-PRNG seed word is an ``int``
(``seed``); the reference derives it from its key (``snn._noise_seed``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import f32math
from repro_torch.core import ima as ima_lib
from repro_torch.core import lif as lif_lib
from repro_torch.core import macro as macro_lib
from repro_torch.core import prbs as prbs_lib
from repro_torch.core import ternary as ternary_lib
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass(frozen=True)
class SNNConfig:
    n_in: int
    n_hidden: int = 128           # the macro's 128 columns
    n_classes: int = 10
    n_steps: int = 20
    mode: str = "kwn"             # kwn (nld: next slice)
    k: int = 12                   # KWN winners
    code_bits: int = 5
    mac_range: float = 24.0       # NLQ full scale, in integer MAC units
    drive_gain: float = 0.25      # V_mem LSBs per unit drive
    beta: float = 0.9
    v_th1: float = 1.0
    v_th2: float = 0.6
    noise_amp: float = 0.05
    use_snl: bool = True
    hidden_layers: tuple[int, ...] | None = None   # stacks: multi-layer slice


def _check_supported(cfg: SNNConfig) -> None:
    if cfg.mode != "kwn":
        raise NotImplementedError("NLD mode is ported in the next slice "
                                  "(the NLD head kernel)")
    if cfg.hidden_layers is not None and len(cfg.hidden_layers) > 1:
        raise NotImplementedError("layer stacks are ported in the "
                                  "multi-layer slice")


def init_params(cfg: SNNConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random weights from ``generator`` (single-layer KWN): ``w_hid``
    (n_in, n_hidden) and ``w_out`` (n_hidden, n_classes), on ``device``."""
    _check_supported(cfg)
    dev = device_lib.resolve(device)
    w_hid = torch.randn((cfg.n_in, cfg.n_hidden), generator=generator) \
        / math.sqrt(cfg.n_in) * 3.0
    w_out = torch.randn((cfg.n_hidden, cfg.n_classes), generator=generator) \
        / math.sqrt(cfg.n_hidden)
    return {"w_hid": w_hid.to(dev), "w_out": w_out.to(dev)}


def _macro_cfg(cfg: SNNConfig, noise) -> macro_lib.CIMMacroConfig:
    return macro_lib.CIMMacroConfig(code_bits=cfg.code_bits,
                                    mac_range=cfg.mac_range, ima_noise=noise)


def pack_fused(p: dict, cfg: SNNConfig, noise=None
               ) -> macro_lib.FusedMacroWeights:
    """Quantize ``w_hid`` onto the twin-cell grid and pack the operands."""
    w_int, scale = ternary_lib.quantize_weights_3bit(p["w_hid"])
    return macro_lib.pack_kwn_weights(w_int, scale.reshape(-1),
                                      _macro_cfg(cfg, noise))


def _lif(cfg: SNNConfig) -> dict:
    return dict(drive_gain=cfg.drive_gain, beta=cfg.beta, v_th1=cfg.v_th1,
                v_th2=cfg.v_th2, v_reset=lif_lib.LIFParams().v_reset,
                v_lim=lif_lib.vmem_limit(lif_lib.LIFParams().vmem_bits),
                use_snl=cfg.use_snl)


def _skip_ratio(activity: torch.Tensor) -> torch.Tensor:
    """``clip(1 - mean(map), 0, 1)`` in f32: an exact integer sum divided
    by the block count (the reference's ``jnp.mean``)."""
    frac = f32math.div(activity.float().sum(), activity.numel())
    return torch.clamp(1.0 - frac, 0.0, 1.0)


def forward_silicon(p: dict, events, cfg: SNNConfig, seed: int = 0,
                    noise: ima_lib.IMANoiseModel | None = None,
                    fused: bool | str = "seq", device=None):
    """Inference through the fused macro kernel: events (B, T, N_in) ->
    (logits (B, classes), telemetry).

    The whole sequence runs in one kernel launch (``fused="seq"``).  Clean,
    the SNL noise is the PRBS-15 stream drawn ``B * n_hidden`` bits per
    step from one LFSR; with ``noise`` (the Fig. 7 ``IMANoiseModel``) both
    the IMA error and the SNL sign noise come from the counter PRNG keyed
    on ``seed``.  Telemetry: per-request means over the actual sequence
    length of ADC steps, LIF updates and SOPs, plus the activity plan's
    skipped-block ratio.
    """
    if fused is not True and fused != "seq":
        raise NotImplementedError(
            f"fused={fused!r}: only the time-major fused path ('seq') is "
            f"ported; the composed and per-step paths come with the "
            f"training slice")
    _check_supported(cfg)
    dev = device_lib.resolve(device)
    ev = torch.as_tensor(events).to(dev, torch.float32)
    b, t_steps = ev.shape[0], ev.shape[1]
    p = {name: torch.as_tensor(w).to(dev) for name, w in p.items()}
    fw = pack_fused(p, cfg, noise)
    mcfg = _macro_cfg(cfg, noise)
    noisy = noise is not None
    noise_amp = cfg.noise_amp if cfg.use_snl else 0.0
    ima_kn = macro_lib.fused_kernel_noise(fw, mcfg)
    ev_t = ev.transpose(0, 1)                              # (T, B, N_in)
    activity = macro_lib.plan_activity(ev_t, fw, cfg.n_hidden)
    st0 = lif_lib.lif_init((b, cfg.n_hidden), device=dev)
    if noisy:
        noise_t = None          # all noise is generated inside the kernel
    elif cfg.use_snl:
        s0 = torch.tensor([st0.prbs_state], device=dev)
        _, bits = prbs_lib.draw(s0, t_steps * b * cfg.n_hidden)
        noise_t = prbs_lib.bits_to_noise(bits[0], noise_amp).reshape(
            t_steps, b, cfg.n_hidden)
    else:
        noise_t = torch.zeros((t_steps, b, cfg.n_hidden), device=dev)
    _, spk_t, _, steps_t, _ = macro_lib.fused_seq(
        ev_t, fw, st0.v_mem, noise_t, k=cfg.k, **_lif(cfg),
        ima_noise=ima_kn, snl_amp=noise_amp if noisy else 0.0,
        activity=activity, mac_telemetry=False,
        seed=int(seed) if noisy else 0)
    counts = spk_t.sum(0)
    logits = f32math.div(counts, t_steps) @ p["w_out"]
    sops_t = ev_t.abs().sum(-1) * cfg.n_hidden             # (T, B)
    tele = {
        "adc_steps": f32math.div(steps_t.float().sum(0), t_steps),
        "lif_updates": torch.full((b,), float(cfg.k), device=dev),
        "sops": f32math.div(sops_t.sum(0), t_steps),
        "skipped_block_ratio": torch.full((b,), float(_skip_ratio(activity)),
                                          device=dev),
    }
    return logits, tele


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
    for bit.  ``fw`` is the packed weights (``pack_fused``), packed here
    when omitted.
    """
    _check_supported(cfg)
    dev = state.v.device
    mcfg = _macro_cfg(cfg, noise)
    if fw is None:
        fw = pack_fused(p, cfg, noise)
    noisy = noise is not None
    noise_amp = cfg.noise_amp if cfg.use_snl else 0.0
    ima_kn = macro_lib.fused_kernel_noise(fw, mcfg)
    events = events.to(dev, torch.float32)
    r, slots = events.shape[0], events.shape[1]
    activity = macro_lib.plan_activity(events, fw, cfg.n_hidden)
    new_prbs = state.prbs
    if noisy:
        noise_t = None
    elif cfg.use_snl:
        new_prbs, bits = prbs_lib.draw(state.prbs, r * cfg.n_hidden)
        noise_t = prbs_lib.bits_to_noise(bits, noise_amp).reshape(
            slots, r, cfg.n_hidden).transpose(0, 1)
    else:
        noise_t = torch.zeros((r, slots, cfg.n_hidden), device=dev)
    row_ctl = macro_lib.stream_row_ctl(state.seed, state.steps_done)
    v_out, spk_t, _, steps_t, _ = macro_lib.fused_seq(
        events, fw, state.v, noise_t, k=cfg.k, **_lif(cfg),
        ima_noise=ima_kn, snl_amp=noise_amp if noisy else 0.0,
        activity=activity, mac_telemetry=False, row_ctl=row_ctl)
    iota = torch.arange(r, dtype=torch.int32, device=dev)[:, None]
    af = ((state.steps_done[None, :] + iota)
          < state.length[None, :]).float()                 # (R, S)
    counts = state.counts + (spk_t * af[:, :, None]).sum(0)
    adc = state.adc + (steps_t.float() * af).sum(0)
    sops = state.sops + (events.abs().sum(-1) * af).sum(0) * cfg.n_hidden
    ratio = _skip_ratio(activity)
    skip_acc = state.skip_acc + ratio * af.sum(0)
    steps_done = torch.minimum(state.steps_done + r, state.length)
    return SiliconStreamState(v=v_out, prbs=new_prbs, counts=counts,
                              adc=adc, sops=sops, skip_acc=skip_acc,
                              steps_done=steps_done, length=state.length,
                              seed=state.seed)
