"""Digital LIF neuron parameters (paper C5, Eq. 1, Fig. 5).

Counterpart of ``repro.core.lif``: the parameters, the initial state, the
register saturation value and the spike function with its surrogate
gradient (software BPTT).  The silicon update runs inside the fused macro
kernel and its plain version (``kernels.ref.lif_update``).
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
    prbs_state: int            # LFSR state


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
