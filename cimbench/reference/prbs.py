"""PRBS-15: the SNL noise of the clean KWN path, for the benchmark's
reference.

A frozen copy of the parts of ``repro_torch.core.prbs`` that the clean
path draws from: one 15-bit Fibonacci LFSR (taps 15, 14, period
2^15 - 1), seeded as a fresh LIF state seeds it, giving ``b * width``
bits per step, each bit a kick of ``+-amp``.
"""

from __future__ import annotations

import numpy as np
import torch

WIDTH = 15
PERIOD = (1 << WIDTH) - 1
TAPS = (15, 14)


def _cycle() -> tuple[np.ndarray, np.ndarray]:
    """The register's states in the order it visits them, and each
    state's position in that order."""
    states = np.empty(PERIOD, np.int64)
    s = 1
    for i in range(PERIOD):
        states[i] = s
        fb = ((s >> (TAPS[0] - 1)) ^ (s >> (TAPS[1] - 1))) & 1
        s = ((s << 1) | fb) & PERIOD
    if s != 1 or len(set(states.tolist())) != PERIOD:
        raise AssertionError("PRBS-15 polynomial is not maximal")
    index = np.full(PERIOD + 1, -1, np.int64)
    index[states] = np.arange(PERIOD)
    return states, index


def sequence_noise(b: int, t_steps: int, width: int, amp: float,
                   device) -> torch.Tensor:
    """(T, b, width) f32 kicks of ``+-amp``: ``t_steps * b * width``
    consecutive output bits of the register started from state 2 (a
    fresh LIF state's seed 1, plus one), one bit per (step, row,
    column) in that order."""
    states, index = _cycle()
    cycle = torch.from_numpy(states).to(device)
    start = int(index[2])
    offs = torch.arange(1, t_steps * b * width + 1, device=device)
    bits = cycle[(start + offs) % PERIOD] & 1
    return ((2.0 * bits.float() - 1.0) * amp).reshape(t_steps, b, width)
