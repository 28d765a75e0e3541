"""CIM macro seam: packed operands and the fused sequence entry point.

Counterpart of ``repro.core.macro`` (the fused KWN path).  Models call
this layer, never the kernels: ``pack_kwn_weights`` turns integer weights
into the device operands, ``plan_fused_tiles`` / ``plan_activity`` expose
the tile plan and its occupancy map, and ``fused_seq`` runs a whole event
sequence through the fused macro kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import ima as ima_lib
from repro_torch.core import ternary as ternary_lib

class CIMMacroConfig(NamedTuple):
    code_bits: int = 5                 # IMA resolution
    mac_range: float = 64.0            # full-scale MAC range (weight LSBs)
    nlq_gamma: float = 2.0
    ima_noise: ima_lib.IMANoiseModel | None = None  # None = ideal conversion


def _nlq(cfg: CIMMacroConfig) -> ima_lib.RampCodebook:
    return ima_lib.nlq_codebook(cfg.code_bits, -cfg.mac_range, cfg.mac_range,
                                cfg.nlq_gamma)


class FusedMacroWeights(NamedTuple):
    """Device operands of the fused kernel (KWN mode).

    msb/lsb (I, N) int8 twin-cell planes, scale (N,) per-column weight
    scale, boundaries (n_codes - 1,) ramp thresholds, levels (n_codes,)
    LUT.
    """

    msb: torch.Tensor
    lsb: torch.Tensor
    scale: torch.Tensor
    boundaries: torch.Tensor
    levels: torch.Tensor


def pack_kwn_weights(w_int: torch.Tensor, scale: torch.Tensor,
                     cfg: CIMMacroConfig) -> FusedMacroWeights:
    """KWN packing: integer weights in [-3, 3] plus per-column scale.

    The NLQ ramp sees integer-unit MACs; the scale multiplies the winner
    drive after the LUT map-back.  Operands land on ``w_int``'s device.
    """
    dev = w_int.device
    msb, lsb = ternary_lib.weight_decompose(w_int)
    nlq = _nlq(cfg)
    return FusedMacroWeights(
        msb=ternary_lib.pack_ternary(msb), lsb=ternary_lib.pack_ternary(lsb),
        scale=scale.reshape(-1).to(torch.float32),
        boundaries=nlq.boundaries.to(dev), levels=nlq.levels.to(dev))


def plan_fused_tiles(batch: int, fw: FusedMacroWeights, n_out: int,
                     n_steps: int = 1):
    """The ``TilePlan`` of one fused launch over ``batch`` rows."""
    from repro_torch.kernels import fused_macro
    n_in, nc = fw.msb.shape
    return fused_macro.plan_tiles(batch, n_in, nc, n_out, n_steps)


def plan_activity(spikes: torch.Tensor, fw: FusedMacroWeights,
                  n_out: int) -> torch.Tensor:
    """Occupancy map (T, row-tiles, K-tiles) int32 of a time-major event
    sequence (T, ..., I), on the plan ``plan_fused_tiles`` picks."""
    from repro_torch.kernels import ops
    s = ternary_lib.ternary_input_encode(spikes)
    t = s.shape[0]
    xm = s.reshape(t, -1, s.shape[-1])
    plan = plan_fused_tiles(xm.shape[1], fw, n_out, n_steps=t)
    xm = F.pad(xm, (0, plan.k_pad - xm.shape[-1], 0, plan.m_pad - xm.shape[1]))
    return ops.fused_activity_map(xm, plan)


def fused_kernel_noise(fw: FusedMacroWeights, cfg: CIMMacroConfig
                       ) -> ima_lib.IMAKernelNoise | None:
    """The kernel's Fig. 7 noise parameters for ``cfg.ima_noise`` over the
    ramp's full scale ``±cfg.mac_range``; None when the config is ideal."""
    if cfg.ima_noise is None:
        return None
    cb = ima_lib.RampCodebook(fw.levels, fw.boundaries,
                              -cfg.mac_range, cfg.mac_range)
    return ima_lib.kernel_noise_params(cfg.ima_noise, cb)


def stream_row_ctl(seeds: torch.Tensor, step_offsets: torch.Tensor,
                   row_ids: torch.Tensor | None = None) -> torch.Tensor:
    """(S, 3) int32 ``[seed, step_offset, row_id]`` per serving slot.

    ``row_ids`` defaults to zeros: every slot replays row 0 of its own
    batch-1 stream, so slot state is relocatable.
    """
    seeds = seeds.to(torch.int32)
    rows = torch.zeros_like(seeds) if row_ids is None \
        else row_ids.to(torch.int32)
    return torch.stack([seeds, step_offsets.to(torch.int32), rows], dim=-1)


def fused_seq(spikes: torch.Tensor, fw: FusedMacroWeights, v: torch.Tensor,
              noise: torch.Tensor | None = None, *, k: int = 12,
              drive_gain: float = 1.0, beta: float = 0.9,
              v_th1: float = 1.0, v_th2: float = 0.6,
              v_reset: float = 0.0, v_lim: float = 8.0,
              use_snl: bool = True, ima_noise=None, snl_amp: float = 0.0,
              activity: torch.Tensor | None = None,
              mac_telemetry: bool = True, seed=0, step_offset=0,
              row_ctl: torch.Tensor | None = None):
    """A whole event sequence through the fused kernel, on ``v``'s device.

    spikes (T, ..., I), v (..., N), noise (T, ..., N) or None for the
    counter streams; ``row_ctl`` (..., 3) per-row stream control.
    Returns (v_out (..., N), spikes (T, ..., N), mask (T, ..., N),
    adc_steps (T, ...), mac (T, ..., N) or None).
    """
    from repro_torch.kernels import ops
    s = ternary_lib.ternary_input_encode(spikes)
    mac, v_out, spk, mask, steps = ops.fused_macro_seq(
        s, fw.msb, fw.lsb, fw.boundaries, fw.levels, fw.scale, v, noise,
        k=k, drive_gain=drive_gain, beta=beta, v_th1=v_th1, v_th2=v_th2,
        v_reset=v_reset, v_lim=v_lim, use_snl=use_snl, ima_noise=ima_noise,
        snl_amp=snl_amp, activity=activity,
        mac_telemetry=mac_telemetry, seed=seed, step_offset=step_offset,
        row_ctl=row_ctl, device=v.device)
    return v_out, spk, mask, steps, mac
