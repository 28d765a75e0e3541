"""Digital LIF neuron parameters (paper C5, Eq. 1, Fig. 5).

Counterpart of ``repro.core.lif`` (inference subset): the parameters, the
initial state and the register saturation value.  The update itself runs
inside the fused macro kernel and its plain version
(``kernels.ref.lif_update``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import prbs


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
