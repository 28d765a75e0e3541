"""Carry weights from the JAX package into the port.

Both functions take plain numpy arrays (``np.asarray`` of the JAX
arrays), so this module imports neither JAX nor ``repro``.  The layouts
are the same on both sides: ``w_hid`` (n_in, n_hidden), ``w_out``
(n_hidden, n_classes), twin-cell planes (n_in, n_hidden).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import macro as macro_lib


def snn_params_from_jax(p: dict, device=None) -> dict:
    """The port's single-layer KWN params from the reference's
    ``{"w_hid", "w_out"}`` (f32 arrays)."""
    dev = device_lib.resolve(device)
    return {name: torch.from_numpy(np.array(p[name], np.float32)).to(dev)
            for name in ("w_hid", "w_out")}


def fused_weights_from_jax(fw, device=None) -> macro_lib.FusedMacroWeights:
    """The port's ``FusedMacroWeights`` from a packed reference
    ``FusedMacroWeights`` (KWN mode: msb, lsb, scale, boundaries, levels)."""
    if fw.mode != "kwn":
        raise NotImplementedError("NLD weights are carried in the next slice")
    dev = device_lib.resolve(device)

    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(dev)

    return macro_lib.FusedMacroWeights(
        msb=put(fw.msb, np.int8), lsb=put(fw.lsb, np.int8),
        scale=put(fw.scale, np.float32).reshape(-1),
        boundaries=put(fw.boundaries, np.float32),
        levels=put(fw.levels, np.float32))
