"""Digital LIF neuron with SNL + PRBS noise (paper C5, Eq. 1, Fig. 5).

Counterpart of ``repro.core.lif``: the parameters, the initial state, the
register saturation value, the spike function with its surrogate gradient
(software BPTT), the composed path's state update ``lif_step`` /
``lif_run``, and the update itself, ``lif_update``, which every kernel's
plain version (``kernels.ref``) shares and the kernels carry in CUDA.

Winners leak and integrate as one fused multiply-add ``fma(beta, v,
drive)``: the reference runs the update inside ``lax.scan`` or a Pallas
kernel, whose bodies XLA compiles and contracts, so that is the arithmetic
to follow (the eager ``beta * v + drive`` rounds twice and differs).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import f32math, prbs


class LIFParams(NamedTuple):
    beta: float = 0.9          # leak factor
    v_th1: float = 1.0         # firing threshold
    v_th2: float = 0.6         # SNL lower threshold (V_th2 < V_mem < V_th1)
    v_reset: float = 0.0
    noise_amp: float = 0.05    # PRBS injection amplitude (V_mem LSBs)
    vmem_bits: int = 12        # register width; V_mem is clipped to this range
    surrogate_beta: float = 4.0


class LIFState(NamedTuple):
    v_mem: torch.Tensor        # (..., N) f32
    prbs_state: int | torch.Tensor   # LFSR state (int, or 0-d int64 tensor)


def lif_init(shape, seed: int = 1, device=None) -> LIFState:
    return LIFState(torch.zeros(shape, dtype=torch.float32, device=device),
                    prbs.lfsr_init(seed))


def vmem_limit(bits: int) -> float:
    """Signed V_mem register full scale (``bits`` wide, 8 fractional bits)."""
    return float(2 ** (bits - 1)) / 256.0


class _SpikeFn(torch.autograd.Function):
    """``v >= v_th`` forward; the SuperSpike fast-sigmoid surrogate
    ``4 / (1 + |4 (v - v_th)|)^2`` backward."""

    @staticmethod
    def forward(ctx, v, v_th: float):
        ctx.save_for_backward(v)
        ctx.v_th = v_th
        return (v >= v_th).float()

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        beta = 4.0
        d = 1.0 + torch.abs(beta * (v - ctx.v_th))
        return g * (f32math.div(torch.ones_like(d), d * d) * beta), None


def spike_fn(v: torch.Tensor, v_th: float) -> torch.Tensor:
    """Heaviside spike with the SuperSpike surrogate gradient (beta 4)."""
    return _SpikeFn.apply(v, float(v_th))


def lif_update(v, drive, mask, noise, *, beta, v_th1, v_th2, v_reset, v_lim,
               use_snl):
    """Eq. (1): winners leak and integrate (one fused multiply-add), the
    rest hold; SNL kick in (v_th2, v_th1); saturate; compare; reset.
    Returns (v_out, spike, v_clip): ``v_clip`` is the saturated membrane
    before the reset, the training trace."""
    v_new = torch.where(mask > 0, f32math.fma(beta, v, drive), v)
    if use_snl:
        snl = (v_new > v_th2) & (v_new < v_th1)
        v_new = torch.where(snl, v_new + noise, v_new)
    v_new = torch.clamp(v_new, -v_lim, v_lim)
    spike = (v_new >= v_th1).float()
    return (torch.where(spike > 0, torch.full_like(v_new, v_reset), v_new),
            spike, v_new)


def lif_step(state: LIFState, drive: torch.Tensor, p: LIFParams,
             update_mask: torch.Tensor | None = None,
             use_snl: bool = True) -> tuple[LIFState, torch.Tensor]:
    """One time step of Eq. (1).

    drive (..., N) the LUT-mapped input (zero for KWN losers);
    update_mask (..., N) 1 for winners, or None for the dense NLD update;
    use_snl turns on the sensitive-neuron kick.  With a mask and SNL the
    PRBS noise is drawn for the whole tensor, winners or not (the kick
    reaches every neuron in (v_th2, v_th1)); without a mask the PRBS state
    stays where it is.  Returns (new_state, spikes).
    """
    v = state.v_mem
    snl = update_mask is not None and use_snl
    noise_state, noise = state.prbs_state, None
    if snl:
        noise_state, noise = prbs.prbs_noise(state.prbs_state, v.shape,
                                             p.noise_amp, device=v.device)
    mask = torch.ones_like(v) if update_mask is None else update_mask
    v_out, s, _ = lif_update(v, drive, mask, noise, beta=p.beta,
                             v_th1=p.v_th1, v_th2=p.v_th2,
                             v_reset=p.v_reset,
                             v_lim=vmem_limit(p.vmem_bits), use_snl=snl)
    return LIFState(v_out, noise_state), s


def lif_run(state: LIFState, drives: torch.Tensor, p: LIFParams,
            update_masks: torch.Tensor | None = None,
            use_snl: bool = True) -> tuple[LIFState, torch.Tensor]:
    """``lif_step`` over T time steps: drives (T, ..., N), update_masks
    (T, ..., N) or None.  Returns (final state, spikes (T, ..., N))."""
    spikes = []
    for t in range(drives.shape[0]):
        state, s = lif_step(state, drives[t], p,
                            None if update_masks is None
                            else update_masks[t], use_snl)
        spikes.append(s)
    return state, torch.stack(spikes)
