"""Roofline terms of a step on one H100.

compute    = FLOPs per device / peak FLOP/s
memory     = bytes per device / HBM bandwidth
collective = wire bytes per device / interconnect bandwidth

Counterpart of the part of ``repro.roofline.analysis`` that needs no
compiler: the hardware constants, ``Roofline`` and ``model_flops``.  The
constants are the H100 SXM's (NVIDIA's data sheet, dense rates without
sparsity, at its 700 W limit), where the reference has a TPU v5e's.  The
reference's HLO parse (``collective_bytes``, ``from_compiled``) reads an
XLA executable and has no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Any

PEAK_FLOPS = 989e12      # bf16 dense tensor-core FLOP/s
PEAK_INT8_OPS = 1979e12  # int8 dense tensor-core op/s
HBM_BW = 3.35e12         # bytes/s
# NVLink 4: 900 GB/s a GPU over its 18 links, both directions together
# (H100 SXM data sheet), so 450 GB/s each way
ICI_BW = 450e9           # bytes/s


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    model_flops_per_device: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.wire_bytes_per_device / ICI_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_frac(self) -> float:
        if self.flops_per_device == 0:
            return 0.0
        return self.model_flops_per_device / self.flops_per_device

    @property
    def roofline_frac(self) -> float:
        """The share of the peak the step would reach if it ran at the
        dominant term's bound and only model FLOPs counted."""
        if self.bound_s == 0:
            return 0.0
        return (self.model_flops_per_device / PEAK_FLOPS) / self.bound_s

    def as_dict(self) -> dict[str, Any]:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "model_flops_per_device": self.model_flops_per_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac,
        }


def model_flops(n_active_params: int, n_tokens: int, kind: str,
                n_devices: int) -> float:
    """6 N D (forward and backward) for a training step, 2 N D for an
    inference step, per device."""
    per_tok = 6 * n_active_params if kind == "train" else 2 * n_active_params
    return per_tok * n_tokens / n_devices
