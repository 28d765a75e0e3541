"""Gradient compression with error feedback.

Counterpart of ``repro.train.compression``: int8 quantisation of each
gradient leaf with one f32 scale a leaf (its largest magnitude over 127)
and an error-feedback residual carried into the next step, which keeps
the accumulated compressed gradient within one quantisation step of the
true sum.  On a data-parallel all-reduce it cuts the wire volume to a
quarter of f32's:

    comp, efb = compress(grads, efb)     # quantise, update the residual
    ...                                  # all-reduce comp
    grads = decompress(comp)
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import f32math
from repro_torch.nn.module import leaves, tree_map

Tree = Any


class Compressed(NamedTuple):
    q: Tree        # int8 leaves
    scale: Tree    # one f32 scalar a leaf


def init_error_feedback(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _one(g: torch.Tensor, e: torch.Tensor | None):
    gf = g.float() if e is None else g.float() + e
    scale = f32math.div(torch.clamp(torch.amax(torch.abs(gf)), min=1e-12),
                        127.0)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale, gf - q.float() * scale


def compress(grads: Tree, error_fb: Tree | None = None
             ) -> tuple[Compressed, Tree]:
    """(the int8 leaves and their scales, the new residual)."""
    if error_fb is None:
        out = tree_map(lambda g: _one(g, None), grads)
    else:
        out = tree_map(_one, grads, error_fb)
    q, scale, err = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
    return Compressed(q, scale), err


def decompress(comp: Compressed) -> Tree:
    return tree_map(lambda q, s: q.float() * s, comp.q, comp.scale)


def compression_ratio(grads: Tree) -> float:
    """Wire bytes against f32's (the int8 payload; the scales are
    negligible)."""
    total = sum(x.numel() for x in leaves(grads))
    return (total * 1) / (total * 4)
