"""Macro building blocks: ternary weights, IMA ramp, LIF, noise sources."""
