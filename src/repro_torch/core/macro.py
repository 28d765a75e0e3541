"""CIM macro: the composed stage functions, packed operands and the fused
sequence entry points.

Counterpart of ``repro.core.macro``.  Two execution paths, as in the
reference:

* **composed** (``cim_mac`` / ``kwn_forward`` / ``nld_forward`` /
  ``tiled_cim_mac``): each stage a separate PyTorch computation with its
  intermediates visible.  The MAC is a plain ``einsum`` of ternary events
  with small integer weights (exact in f32 in any order; the matmul is
  never lowered to TF32), as the reference leaves it to XLA outside any
  kernel.  ``MacroGeometry`` counts the physical 256x128 macros a layer
  tiles onto;
* **fused**: ``pack_kwn_weights`` / ``pack_nld_weights`` /
  ``pack_kwn_stack`` turn weights into the device operands,
  ``plan_fused_tiles`` / ``plan_activity`` / ``plan_fused_stack`` expose the
  tile plans and the occupancy map, ``fused_seq`` runs a whole event
  sequence through the fused single-layer kernel (KWN or NLD head),
  ``fused_step`` one time step of it, ``fused_multi_seq`` a sequence
  through the stacked KWN kernel, and ``fused_seq_vjp`` the
  differentiable KWN sequence that silicon training runs (the surrogate
  backward kernel behind it).

Models call this layer, never the kernels.  Noise draws of the composed
path come from a ``torch.Generator`` where the reference takes a JAX key.
"""

from __future__ import annotations

from typing import NamedTuple

import math

import torch
import torch.nn.functional as F

from repro_torch.core import dendrite as dendrite_lib
from repro_torch.core import f32math
from repro_torch.core import ima as ima_lib
from repro_torch.core import kwn as kwn_lib
from repro_torch.core import ternary as ternary_lib

MACRO_ROWS = 256   # MAC array word-lines (inputs)
MACRO_COLS = 128   # columns (neurons)
IMA_ROWS = 46      # ramp array rows


class MacroGeometry(NamedTuple):
    n_in: int
    n_out: int
    row_tiles: int
    col_tiles: int

    @property
    def n_macros(self) -> int:
        return self.row_tiles * self.col_tiles


def geometry(n_in: int, n_out: int) -> MacroGeometry:
    """The virtual macro grid an (n_in, n_out) layer tiles onto."""
    return MacroGeometry(n_in, n_out,
                         row_tiles=math.ceil(n_in / MACRO_ROWS),
                         col_tiles=math.ceil(n_out / MACRO_COLS))


class CIMMacroConfig(NamedTuple):
    code_bits: int = 5                 # IMA resolution
    mac_range: float = 64.0            # full-scale MAC range (weight LSBs)
    nlq_gamma: float = 2.0
    ratio_sigma: float = 0.0           # MC current-ratio spread (0 = ideal)
    ima_noise: ima_lib.IMANoiseModel | None = None  # None = ideal conversion


def _nlq(cfg: CIMMacroConfig) -> ima_lib.RampCodebook:
    return ima_lib.nlq_codebook(cfg.code_bits, -cfg.mac_range, cfg.mac_range,
                                cfg.nlq_gamma)


def _codebooks(cfg: CIMMacroConfig
               ) -> tuple[ima_lib.RampCodebook, ima_lib.RampCodebook]:
    """The linear and the NLQ ramp over ``±cfg.mac_range``."""
    lin = ima_lib.linear_codebook(cfg.code_bits, -cfg.mac_range,
                                  cfg.mac_range)
    return lin, _nlq(cfg)


# --- the composed path --------------------------------------------------------

def cim_mac(spikes: torch.Tensor, w_int: torch.Tensor, cfg: CIMMacroConfig,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Analog ternary MAC: spikes (..., I) x integer weights (I, N) in
    [-3, 3], through the twin-cell split; with ``cfg.ratio_sigma > 0`` and
    a generator, a per-column current ratio drawn from it."""
    msb, lsb = ternary_lib.weight_decompose(w_int)
    if cfg.ratio_sigma > 0.0 and generator is not None:
        w_eff = ternary_lib.effective_weights(msb, lsb, generator,
                                              cfg.ratio_sigma)
    else:
        w_eff = ternary_lib.weight_compose(msb, lsb)
    s = ternary_lib.ternary_input_encode(spikes)
    return torch.einsum("...i,in->...n", s, w_eff)


def kwn_forward(spikes: torch.Tensor, w_int: torch.Tensor, k: int,
                cfg: CIMMacroConfig,
                generator: torch.Generator | None = None):
    """KWN mode: MAC -> NLQ ramp (descending) -> top-K early stop.

    With ``cfg.ima_noise`` and a generator the conversion carries the
    Fig. 7 error.  Returns (drive, mask, result): the LUT value of the
    winners and exactly 0 for the rest, the winner mask, and the
    ``KWNResult`` (indices, codes, ADC steps)."""
    nlq = _nlq(cfg).to(w_int.device)
    mac = cim_mac(spikes, w_int, cfg, generator)
    if cfg.ima_noise is not None and generator is not None:
        codes = ima_lib.ima_convert_noisy(mac, nlq, generator, cfg.ima_noise)
        mac_eff = ima_lib.ima_reconstruct(codes, nlq)
    else:
        mac_eff = mac
    res = kwn_lib.kwn_select(mac_eff, k, nlq)
    drive = ima_lib.ima_quantize(mac_eff, nlq) * res.mask
    return drive, res.mask, res


def nld_forward(spikes: torch.Tensor,
                dendrite_params: dendrite_lib.DendriteParams,
                cfg: CIMMacroConfig, activation: str = "quadratic",
                quantize: bool = True) -> torch.Tensor:
    """NLD mode: the float branch MACs through the NL-activation ramp over
    ``±cfg.mac_range`` (or the ideal activation without ``quantize``),
    combined at the soma (Eq. 2).  The branch MACs are a float ``einsum``:
    its sum order is the library's, so they match the reference to a few
    ULP, not bit for bit (see ``core.dendrite``)."""
    cb = ima_lib.activation_codebook(
        cfg.code_bits, ima_lib.DENDRITE_ACTIVATIONS[activation],
        -cfg.mac_range, cfg.mac_range).to(spikes.device)
    return dendrite_lib.dendrite_mac(
        dendrite_params, spikes, nl_cb=cb if quantize else None,
        f=dendrite_lib.TRAIN_ACTIVATIONS[activation])


def tiled_cim_mac(spikes: torch.Tensor, w_int: torch.Tensor,
                  cfg: CIMMacroConfig
                  ) -> tuple[torch.Tensor, MacroGeometry]:
    """A layer larger than one macro, tiled onto the 256x128 grid: each
    row tile's MAC goes through the linear ramp before the digital add
    across row tiles (in tile order), as the silicon loses precision.
    Returns (out (..., N), geometry)."""
    n_in, n_out = w_int.shape
    geo = geometry(n_in, n_out)
    lin = _codebooks(cfg)[0].to(w_int.device)
    pad_i = geo.row_tiles * MACRO_ROWS - n_in
    pad_n = geo.col_tiles * MACRO_COLS - n_out
    s = F.pad(spikes.float(), (0, pad_i))
    w = F.pad(w_int.float(), (0, pad_n, 0, pad_i))
    s_t = s.reshape(*s.shape[:-1], geo.row_tiles, MACRO_ROWS)
    w_t = w.reshape(geo.row_tiles, MACRO_ROWS, geo.col_tiles * MACRO_COLS)
    msb, lsb = ternary_lib.weight_decompose(w_t)
    partial = torch.einsum("...tr,trn->...tn", s_t,
                           ternary_lib.weight_compose(msb, lsb))
    partial_q = ima_lib.ima_quantize(partial, lin)
    out = partial_q[..., 0, :]
    for t in range(1, geo.row_tiles):
        out = out + partial_q[..., t, :]
    return out[..., :n_out], geo


class FusedMacroWeights(NamedTuple):
    """Device operands of the fused kernel.

    msb/lsb (I, NC) int8 twin-cell planes (NC = N for KWN, J*N branch-major
    for NLD: column j*N + p is branch j of neuron p), scale (NC,)
    per-column weight scale, boundaries (n_codes - 1,) ramp thresholds,
    levels (n_codes,) LUT (NLD: the activation samples), w_dend (J, N)
    soma combine weights or None (KWN), mode "kwn" | "nld".
    """

    msb: torch.Tensor
    lsb: torch.Tensor
    scale: torch.Tensor
    boundaries: torch.Tensor
    levels: torch.Tensor
    w_dend: torch.Tensor | None = None
    mode: str = "kwn"


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


def pack_nld_weights(dendrite_params, cfg: CIMMacroConfig,
                     activation: str = "quadratic") -> FusedMacroWeights:
    """NLD packing: branch weights onto the twin-cell grid.

    Per (branch, column) scale ``max|w| / 3`` (at least 1e-8), integer
    weights ``round(clip(w / scale, -3, 3))`` (half to even), branch-major
    flat columns; the ramp is the activation codebook over
    ``±cfg.mac_range`` (the model passes ``dend_range`` there).
    """
    w_syn = dendrite_params.w_syn * dendrite_params.mask   # (J, I, N)
    n_branches, n_in, n_out = w_syn.shape
    scale = torch.clamp(f32math.div(torch.amax(torch.abs(w_syn), dim=1),
                                    3.0), min=1e-8)       # (J, N)
    w_int = torch.round(torch.clamp(f32math.div(w_syn, scale[:, None, :]),
                                    -3, 3))
    msb, lsb = ternary_lib.weight_decompose(w_int)

    def flat(a):     # (J, I, N) -> (I, J*N), branch-major columns
        return a.permute(1, 0, 2).reshape(n_in, n_branches * n_out)

    cb = ima_lib.activation_codebook(
        cfg.code_bits, ima_lib.DENDRITE_ACTIVATIONS[activation],
        -cfg.mac_range, cfg.mac_range)
    dev = w_syn.device
    return FusedMacroWeights(
        msb=ternary_lib.pack_ternary(flat(msb)).contiguous(),
        lsb=ternary_lib.pack_ternary(flat(lsb)).contiguous(),
        scale=scale.reshape(-1).to(torch.float32),
        boundaries=cb.boundaries.to(dev), levels=cb.levels.to(dev),
        w_dend=dendrite_params.w_dend.to(torch.float32), mode="nld")


def pack_kwn_stack(w_ints, scales, cfg: CIMMacroConfig
                   ) -> list[FusedMacroWeights]:
    """Pack a KWN layer stack: per-layer (I_l, N_l) integer weights and
    (N_l,) scales; the layers chain (I_l == N_{l-1}) and share one ramp."""
    stack = [pack_kwn_weights(w, s, cfg) for w, s in zip(w_ints, scales)]
    for prev, nxt in zip(stack, stack[1:]):
        if nxt.msb.shape[0] != prev.msb.shape[1]:
            raise ValueError(f"layer widths do not chain: "
                             f"{tuple(prev.msb.shape)} -> "
                             f"{tuple(nxt.msb.shape)}")
    return stack


def plan_fused_tiles(batch: int, fw: FusedMacroWeights, n_out: int,
                     n_steps: int = 1):
    """The ``TilePlan`` of one fused launch over ``batch`` rows; ``n_out``
    is the per-neuron width (NC / J in NLD mode)."""
    from repro_torch.kernels import fused_macro
    n_in, nc = fw.msb.shape
    n_branches = nc // n_out if fw.mode == "nld" else 1
    return fused_macro.plan_tiles(batch, n_in, nc, n_out, n_steps,
                                  mode=fw.mode, n_branches=n_branches)


def plan_fused_stack(batch: int, stack, n_steps: int = 1) -> list:
    """Per-layer ``TilePlan`` of a stacked launch.  Layer 0's plan sets the
    row tiling and the host occupancy map; deeper layers' plans describe
    their macro tiling only (the stacked kernel keeps inter-layer widths
    exact)."""
    return [plan_fused_tiles(batch, fw, fw.msb.shape[1], n_steps)
            for fw in stack]


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
    ramp's full scale ``±cfg.mac_range`` (integer MAC units for KWN, float
    branch-MAC units for NLD, where the model sets ``mac_range`` to
    ``dend_range``); None when the config is ideal."""
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
    counter streams (KWN; the NLD head has no SNL noise); ``row_ctl``
    (..., 3) per-row stream control.  ``fw.mode`` picks the head.
    Returns (v_out (..., N), spikes (T, ..., N), mask (T, ..., N),
    adc_steps (T, ...), mac (T, ..., NC) or None).
    """
    from repro_torch.kernels import ops
    s = ternary_lib.ternary_input_encode(spikes)
    mac, v_out, spk, mask, steps = ops.fused_macro_seq(
        s, fw.msb, fw.lsb, fw.boundaries, fw.levels, fw.scale, v, noise,
        fw.w_dend, mode=fw.mode, k=k, drive_gain=drive_gain, beta=beta,
        v_th1=v_th1, v_th2=v_th2, v_reset=v_reset, v_lim=v_lim,
        use_snl=use_snl, ima_noise=ima_noise, snl_amp=snl_amp,
        activity=activity,
        mac_telemetry=mac_telemetry, seed=seed, step_offset=step_offset,
        row_ctl=row_ctl, device=v.device)
    return v_out, spk, mask, steps, mac


def fused_step(spikes: torch.Tensor, fw: FusedMacroWeights, v: torch.Tensor,
               noise: torch.Tensor | None = None, *, k: int = 12,
               drive_gain: float = 1.0, beta: float = 0.9,
               v_th1: float = 1.0, v_th2: float = 0.6,
               v_reset: float = 0.0, v_lim: float = 8.0,
               use_snl: bool = True, ima_noise=None, snl_amp: float = 0.0,
               mac_telemetry: bool = True, seed=0, step_offset=0):
    """One time step through the fused kernel (one launch), on ``v``'s
    device: spikes (..., I), v / noise (..., N).  With counter noise the
    step index goes in ``step_offset``, which keys the stream as the
    sequence path does.  Returns (v_out, spikes, mask, adc_steps (...),
    mac (..., NC) or None)."""
    from repro_torch.kernels import ops
    s = ternary_lib.ternary_input_encode(spikes)
    mac, v_out, spk, mask, steps = ops.fused_macro_step(
        s, fw.msb, fw.lsb, fw.boundaries, fw.levels, fw.scale, v, noise,
        fw.w_dend, mode=fw.mode, k=k, drive_gain=drive_gain, beta=beta,
        v_th1=v_th1, v_th2=v_th2, v_reset=v_reset, v_lim=v_lim,
        use_snl=use_snl, ima_noise=ima_noise, snl_amp=snl_amp,
        mac_telemetry=mac_telemetry, seed=seed, step_offset=step_offset,
        device=v.device)
    return v_out, spk, mask, steps, mac


def fused_seq_vjp(spikes: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                  cfg: CIMMacroConfig, v: torch.Tensor, *, k: int = 12,
                  drive_gain: float = 1.0, beta: float = 0.9,
                  v_th1: float = 1.0, v_th2: float = 0.6,
                  v_reset: float = 0.0, v_lim: float = 8.0,
                  use_snl: bool = True, noise: torch.Tensor | None = None,
                  snl_amp: float = 0.0, kwn_relax: float = 0.0,
                  remat: bool = False, seed: int = 0):
    """Differentiable fused KWN sequence, on ``spikes``' device: the
    silicon-in-the-loop training forward, with the surrogate backward
    kernel behind it.

    spikes (T, ..., I) events (no gradient), w (I, N) f32 weight in integer
    MAC units (gradient straight through the twin-cell rounding; the model
    layer puts its own clipped straight-through in front), scale (N,)
    per-column scale (no gradient), v (..., N) initial membrane.
    ``cfg.ima_noise`` turns on the Fig. 7 counter noise keyed on ``seed``
    (a fresh seed per optimization step); ``noise`` (T, ..., N) is the
    clean path's streamed SNL noise, None for the counter SNL stream at
    ``snl_amp`` (or none when ``use_snl`` is off).  The ramp's
    straight-through window is ``+-(cfg.mac_range + 0.5)``; ``kwn_relax``
    and ``remat`` as in ``kernels.ops.SeqVJPSpec``.

    Returns (spikes_out (T, ..., N), v_out (..., N)), both differentiable.
    """
    from repro_torch.kernels import ops
    nlq = _nlq(cfg)
    ima_kn = None
    if cfg.ima_noise is not None:
        ima_kn = ima_lib.kernel_noise_params(cfg.ima_noise, nlq)
    spec = ops.SeqVJPSpec(
        k=k, drive_gain=drive_gain, beta=beta, v_th1=v_th1, v_th2=v_th2,
        v_reset=v_reset, v_lim=v_lim, use_snl=use_snl, ima_noise=ima_kn,
        snl_amp=snl_amp, kwn_relax=kwn_relax,
        ste_lo=float(-cfg.mac_range - 0.5), ste_hi=float(cfg.mac_range + 0.5),
        remat=remat)
    dev = spikes.device
    s = ternary_lib.ternary_input_encode(spikes)
    return ops.fused_macro_seq_vjp(
        spec, w, s, nlq.boundaries.to(dev), nlq.levels.to(dev),
        scale.reshape(-1).to(torch.float32), v, noise, seed)


def fused_multi_seq(spikes: torch.Tensor, stack, vs, noises=None, *, ks,
                    drive_gain: float = 1.0, beta: float = 0.9,
                    v_th1: float = 1.0, v_th2: float = 0.6,
                    v_reset: float = 0.0, v_lim: float = 8.0,
                    use_snl: bool = True, ima_noise=None,
                    snl_amp: float = 0.0, seeds=None, step_offset=0):
    """A whole event sequence through L stacked KWN layers, one launch.

    spikes (T, ..., I), stack a ``pack_kwn_stack`` result, vs per-layer
    (..., N_l) membranes, noises per-layer (T, ..., N_l) pre-drawn SNL
    noise or None for the counter streams, ks per-layer winner counts,
    seeds per-layer counter seeds (keep them distinct).  The inter-layer
    spikes are not returned.  Returns ``kernels.ops.MultiSeqOut``.
    """
    from repro_torch.kernels import ops
    if any(fw.mode != "kwn" for fw in stack):
        raise ValueError("the stacked fused path is KWN-only")
    s = ternary_lib.ternary_input_encode(spikes)
    return ops.fused_macro_multi_seq(
        s, [(fw.msb, fw.lsb, fw.boundaries, fw.levels, fw.scale)
            for fw in stack],
        vs, noises, ks=ks, drive_gain=drive_gain, beta=beta, v_th1=v_th1,
        v_th2=v_th2, v_reset=v_reset, v_lim=v_lim, use_snl=use_snl,
        ima_noise=ima_noise, snl_amp=snl_amp, seeds=seeds,
        step_offset=step_offset, device=spikes.device)
