"""PRBS-15 LFSR noise for the SNL path (paper C5, Fig. 5a).

Fibonacci LFSR ``x^15 + x^14 + 1``: each step shifts the feedback bit
``b15 ^ b14`` in at the bottom and emits it.  Counterpart of
``repro.core.prbs``.  The generator has one maximal cycle of 32767
states, so the port precomputes it once: a draw of ``n`` bits from state
``s`` is a gather of the ``n`` states that follow ``s`` on the cycle (the
emitted bit is each new state's low bit), which lets every serving slot
draw its own stream in one tensor operation.

The precomputed cycle holds only for the default generator (width 15,
taps (15, 14)).  Any other ``width`` or ``taps`` steps the register one
bit at a time, as the reference does: with the default taps a width
under 15 never sees bits 14 and 13, so its feedback is always 0 and the
register shifts itself to 0, in the reference and here alike.

Two draw orders exist, and both reproduce the reference exactly:

* the one-shot sequence path draws ``b * n_hidden`` bits per step from a
  single LFSR, step after step (``draw(state, T * b * n)`` reshaped
  ``(T, b, n)``; the composed path draws the same bits a step at a time
  with ``prbs_noise``, threading the state);
* the streaming path keeps one LFSR per slot and draws ``n_hidden`` bits
  per step per slot (``draw(states, R * n)`` reshaped ``(S, R, n)``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

WIDTH = 15
PERIOD = (1 << WIDTH) - 1
PRBS15_TAPS = (15, 14)


def lfsr_init(seed: int, width: int = WIDTH) -> int:
    """Non-zero LFSR state from an integer seed."""
    return (seed % ((1 << width) - 1)) + 1


def lfsr_step(state: int, width: int = WIDTH,
              taps: tuple[int, int] = PRBS15_TAPS) -> tuple[int, int]:
    """One LFSR step; returns (new_state, output_bit)."""
    fb = ((state >> (taps[0] - 1)) ^ (state >> (taps[1] - 1))) & 1
    return ((state << 1) | fb) & ((1 << width) - 1), fb


@functools.lru_cache(maxsize=1)
def _cycle_np() -> tuple[np.ndarray, np.ndarray]:
    states = np.empty(PERIOD, np.int64)
    s = 1
    for i in range(PERIOD):
        states[i] = s
        s, _ = lfsr_step(s)
    if s != 1 or len(set(states.tolist())) != PERIOD:
        raise AssertionError("PRBS-15 polynomial is not maximal")
    index = np.full(PERIOD + 1, -1, np.int64)
    index[states] = np.arange(PERIOD)
    return states, index


@functools.lru_cache(maxsize=8)
def _cycle(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    states, index = _cycle_np()
    return (torch.from_numpy(states).to(device),
            torch.from_numpy(index).to(device))


def draw(states: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw ``n`` consecutive bits from each LFSR state in ``states``.

    Returns ``(new_states, bits)`` with ``bits`` shaped
    ``states.shape + (n,)`` (int64 in {0, 1}).
    """
    cycle, index = _cycle(states.device)
    pos = index[states.long()]
    offs = torch.arange(1, n + 1, device=states.device)
    bits = cycle[(pos[..., None] + offs) % PERIOD] & 1
    return cycle[(pos + n) % PERIOD], bits


def bits_to_noise(bits: torch.Tensor, amplitude: float) -> torch.Tensor:
    """Two-level noise ``(2 * bit - 1) * amplitude`` in f32."""
    return (2.0 * bits.float() - 1.0) * amplitude


def _stepped(state: int, n: int, width: int) -> tuple[int, list[int]]:
    """``n`` bits of the default taps' register at ``width``, one step at
    a time."""
    bits = []
    for _ in range(n):
        state, b = lfsr_step(state, width)
        bits.append(b)
    return state, bits


def prbs_bits(state, n: int, width: int = WIDTH, device=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` bits of the LFSR in ``state`` (an int, or a one-element int64
    tensor, which fixes the device).  Returns ``(new_state, bits)``: the
    state a 0-d int64 tensor and the bits int32 (n,).

    Width 15 from a state of the cycle gathers from it; any other width,
    and the all-zero or out-of-range states, step the register.  A state
    on the card is taken to be one of the cycle's (``lfsr_init`` and every
    draw give one), since reading it would wait for the device."""
    if isinstance(state, torch.Tensor):
        device = state.device
    s = torch.as_tensor(state, dtype=torch.int64, device=device).reshape(1)
    if width == WIDTH and (s.is_cuda or 1 <= int(s[0]) <= PERIOD):
        new, bits = draw(s, n)
        return new[0], bits[0].to(torch.int32)
    new, bits = _stepped(int(s[0]), n, width)
    return (torch.tensor(new, dtype=torch.int64, device=s.device),
            torch.tensor(bits, dtype=torch.int32, device=s.device))


def prbs_noise(state, shape, amplitude: float, width: int = WIDTH,
               device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric two-level noise in {-amplitude, +amplitude} of ``shape``:
    ``prod(shape)`` bits from the one LFSR in ``state`` (an int, or a
    one-element int64 tensor, which fixes the device).  Returns
    ``(new_state, noise)``, the state a 0-d int64 tensor, so that a loop
    threading it never waits for the device."""
    new, bits = prbs_bits(state, math.prod(int(d) for d in shape), width,
                          device)
    return new, bits_to_noise(bits, amplitude).reshape(shape)


def sequence_noise(b: int, t_steps: int, width: int, amp: float,
                   device=None) -> torch.Tensor:
    """The clean-path SNL noise of a fresh LIF state (``lif_init``'s LFSR
    word) over a one-shot sequence: ``b * width`` bits per step from one
    LFSR, (T, b, width) f32."""
    s0 = torch.tensor([lfsr_init(1)], device=device)
    _, bits = draw(s0, t_steps * b * width)
    return bits_to_noise(bits[0], amp).reshape(t_steps, b, width)
