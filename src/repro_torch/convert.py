"""Carry weights from the JAX package into the port.

The functions take plain numpy arrays (``np.asarray`` of the JAX arrays,
or objects whose fields are such arrays), so this module imports neither
JAX nor ``repro``.  The layouts are the same on both sides: ``w_hid``
(n_in, n_hidden) or a list of per-layer arrays for a stack, ``w_out``
(n_hidden, n_classes), ``dend`` with ``w_syn`` / ``mask`` (J, n_in,
n_hidden) and ``w_dend`` (J, n_hidden), twin-cell planes (n_in, NC); the
LM's parameters are the same nested dict on both sides.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import dendrite as dendrite_lib
from repro_torch.core import macro as macro_lib


def _put(a, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype)).to(dev)


def snn_params_from_jax(p: dict, device=None) -> dict:
    """The port's SNN params from the reference's: ``w_out`` and either
    ``w_hid`` (an array, or a list for a stack) or ``dend`` (NLD), f32."""
    dev = device_lib.resolve(device)
    out = {"w_out": _put(p["w_out"], np.float32, dev)}
    if "dend" in p:
        d = p["dend"]
        out["dend"] = dendrite_lib.DendriteParams(
            *(_put(getattr(d, name), np.float32, dev)
              for name in ("w_syn", "w_dend", "mask")))
    elif isinstance(p["w_hid"], (list, tuple)):
        out["w_hid"] = [_put(w, np.float32, dev) for w in p["w_hid"]]
    else:
        out["w_hid"] = _put(p["w_hid"], np.float32, dev)
    return out


def fused_weights_from_jax(fw, device=None) -> macro_lib.FusedMacroWeights:
    """The port's ``FusedMacroWeights`` from a packed reference
    ``FusedMacroWeights`` (KWN or NLD)."""
    dev = device_lib.resolve(device)
    return macro_lib.FusedMacroWeights(
        msb=_put(fw.msb, np.int8, dev), lsb=_put(fw.lsb, np.int8, dev),
        scale=_put(fw.scale, np.float32, dev).reshape(-1),
        boundaries=_put(fw.boundaries, np.float32, dev),
        levels=_put(fw.levels, np.float32, dev),
        w_dend=None if fw.w_dend is None
        else _put(fw.w_dend, np.float32, dev),
        mode=fw.mode)


def lm_params_from_jax(tree: dict, device=None) -> dict:
    """The port's LM params from the reference's (``models.lm`` layout,
    a nested dict of arrays), leaf for leaf, dtypes kept."""
    dev = device_lib.resolve(device)

    def put(node):
        if isinstance(node, dict):
            return {k: put(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node)).to(dev)

    return put(tree)
