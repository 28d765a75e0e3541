"""Param-spec micro-framework: shapes and logical axes, no magic.

Counterpart of ``repro.nn.module``.  Models are plain functions over
nested dicts of tensors; ``param_specs`` builders return the same nested
structure holding :class:`ParamSpec` leaves, and ``materialize`` turns it
into initialised tensors.  The initialisers have the reference's
distributions and scales (``_init_leaf``), drawn from an explicit
``torch.Generator`` in the order of the sorted keys, so the bits differ
from ``jax.random``'s; tests that compare with the reference materialise
on the JAX side and carry the arrays across (``convert.lm_params_from_jax``).

The sharding half of the reference (``partition_spec``, ``shardings``,
``DEFAULT_RULES``) comes with the distributed slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import device as device_lib

Tree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis name per dim
    dtype: torch.dtype = torch.float32
    init: str = "normal"                  # normal | zeros | ones | embed
    scale: float | None = None            # None -> fan-in 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn, tree: Tree) -> Tree:
    """``fn`` applied to every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaves(tree: Tree) -> list:
    """The leaves of a tree of nested dicts, in sorted-key order (the
    order ``jax.tree.leaves`` gives)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def _init_leaf(spec: ParamSpec, generator: torch.Generator,
               dtype=None) -> torch.Tensor:
    dtype = dtype or spec.dtype
    gdev = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=gdev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=gdev)
    z = torch.randn(spec.shape, generator=generator, device=gdev)
    if spec.init == "embed":
        return (z * (spec.scale or 0.02)).to(dtype)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = spec.scale if spec.scale is not None \
        else 1.0 / math.sqrt(max(fan_in, 1))
    return (z * scale).to(dtype)


def materialize(specs: Tree, generator: torch.Generator, dtype=None,
                device=None) -> Tree:
    """Initialised tensors for a spec tree, drawn from ``generator`` (on
    its own device) leaf by leaf in sorted-key order, then placed on
    ``device`` (``cuda`` unless the caller passes ``device="cpu"``)."""
    dev = device_lib.resolve(device)

    def init(node):
        if is_spec(node):
            return _init_leaf(node, generator, dtype).to(dev)
        return {k: init(node[k]) for k in sorted(node)}

    return init(specs)


def count_params(specs: Tree) -> int:
    return sum(math.prod(s.shape) for s in leaves(specs))
