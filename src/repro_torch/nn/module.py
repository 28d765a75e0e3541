"""Param-spec micro-framework: shapes and logical axes, no magic.

Counterpart of ``repro.nn.module``.  Models are plain functions over
nested dicts of tensors; ``param_specs`` builders return the same nested
structure holding :class:`ParamSpec` leaves, and ``materialize`` turns it
into initialised tensors.  The initialisers have the reference's
distributions and scales (``_init_leaf``), drawn from an explicit
``torch.Generator`` in the order of the sorted keys, so the bits differ
from ``jax.random``'s; tests that compare with the reference materialise
on the JAX side and carry the arrays across (``convert.lm_params_from_jax``).

The sharding half maps each leaf's logical axes onto a mesh's axes
(``DEFAULT_RULES``, ``partition_spec``, ``shardings``) as the reference
does; a spec is a tuple with one entry a dim, ``None``, an axis name or
a tuple of names, its trailing ``None``s dropped (the reference's
``PartitionSpec``).  ``shard`` and ``unshard`` are the edges of
``shard_map`` under autograd.

Under a mesh a rank holds its block of every parameter leaf, the block
of the leaf's ``partition_spec`` (``local_params`` cuts full parameters
so, and ``train.checkpoint.restore(shardings=)`` restores them so): the
counterpart of a global ``jax.Array`` laid out by its sharding.
``gather_param`` makes the whole leaf for compute that every rank runs on
the same inputs, and ``relayout`` hands a leaf to a ``shard_map``-style
function that wants another block of it.

The partitioned step gives each rank its share of the inputs too:
``blocks_like`` cuts a batch or a cache by its logical axes (the layout
of ``shardings_like``), a :class:`Plan` says how a call splits its work
(the batch's axes, the tensor-parallel axis, the cache's slots, and
whether the sequence is cut over the tensor-parallel axis: Megatron
sequence parallelism), and ``take_param`` gathers a dense leaf over its
FSDP axes for one block's compute, its backward reduce-scattering the
gradient onto the block, summed over the ranks of the batch (and over
"model" for a leaf applied to the rank's block of the sequence).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import device as device_lib
from repro_torch.dist import collectives

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


def tree_map(fn, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied to every leaf of a tree of nested dicts, with the
    matching leaves of ``rest`` (trees of the same keys) as further
    arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(t[k] for t in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def leaves(tree: Tree) -> list:
    """The leaves of a tree of nested dicts, in sorted-key order (the
    order ``jax.tree.leaves`` gives)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def unflatten(tree: Tree, values: list) -> Tree:
    """``values``, in ``leaves``' order, in the shape of ``tree``."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(tree)


# A leaf of more elements is drawn in slices of this many along its
# flattened (row-major) order, so that the f32 draw held beside the
# leaf is one slice: a kimi-k2 expert leaf (5.6 G elements) drawn whole
# would hold 45 GB of f32 at once.  Every leaf of a smaller size keeps
# the draw of one ``randn`` over its shape.
DRAW_SLICE_ELEMENTS = 1 << 30


def _init_leaf(spec: ParamSpec, generator: torch.Generator,
               dtype=None) -> torch.Tensor:
    dtype = dtype or spec.dtype
    gdev = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=gdev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=gdev)
    if spec.init == "embed":
        scale = spec.scale or 0.02
    else:
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = spec.scale if spec.scale is not None \
            else 1.0 / math.sqrt(max(fan_in, 1))
    n = math.prod(spec.shape)
    if n <= DRAW_SLICE_ELEMENTS:
        z = torch.randn(spec.shape, generator=generator, device=gdev)
        return z.mul_(scale).to(dtype)
    out = torch.empty(spec.shape, dtype=dtype, device=gdev)
    flat = out.view(-1)
    for lo in range(0, n, DRAW_SLICE_ELEMENTS):
        hi = min(n, lo + DRAW_SLICE_ELEMENTS)
        z = torch.randn(hi - lo, generator=generator, device=gdev)
        flat[lo:hi].copy_(z.mul_(scale))
        del z
    return out


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


# ---------------------------------------------------------------------------
# Logical axis -> mesh sharding
# ---------------------------------------------------------------------------

DEFAULT_RULES: dict[str, tuple[str, ...] | str | None] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "vocab": "model",
    "heads": "model",        # fused n_heads*head_dim projection dim
    "kv_heads": "model",
    "ffn": "model",
    "experts": "model",
    "expert_in": None,
    "expert_ffn": None,
    "cache_seq": "model",    # decode KV cache sequence dim (split-KV)
    "cache_heads": None,
    "conv": None,
    "state": None,
    "classes": "model",
}


def _mesh_axes_for(logical: str | None, rules: dict,
                   mesh) -> tuple[str, ...]:
    if logical is None:
        return ()
    r = rules.get(logical, None)
    if r is None:
        return ()
    axes = (r,) if isinstance(r, str) else tuple(r)
    return tuple(a for a in axes if a in mesh.shape)


def partition_spec(shape: tuple[int, ...], axes: tuple[str | None, ...],
                   mesh, rules: dict | None = None) -> tuple:
    """The spec of a leaf: a mesh axis that does not divide the dim is
    dropped (the blocks must be even) and no mesh axis is used twice.
    Reads only ``mesh.shape`` (axis name -> size)."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    used: set[str] = set()
    parts = []
    for dim, logical in zip(shape, axes):
        chosen: list[str] = []
        prod = 1
        for a in _mesh_axes_for(logical, rules, mesh):
            if a in used:
                continue
            if dim % (prod * mesh.shape[a]) == 0:
                chosen.append(a)
                prod *= mesh.shape[a]
        used.update(chosen)
        if not chosen:
            parts.append(None)
        elif len(chosen) == 1:
            parts.append(chosen[0])
        else:
            parts.append(tuple(chosen))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout: its spec over ``mesh``."""
    mesh: Any
    spec: tuple


def shardings(specs: Tree, mesh, rules: dict | None = None) -> Tree:
    """A :class:`NamedSharding` for every ``ParamSpec`` of a spec tree."""
    return tree_map(lambda s: NamedSharding(
        mesh, partition_spec(s.shape, s.axes, mesh, rules)), specs)


def shardings_like(tree: Tree, axes_tree: Tree, mesh,
                   rules: dict | None = None) -> Tree:
    """Shardings for a tree of tensors given a parallel tree of logical
    axis tuples (caches, batches)."""
    return tree_map(lambda x, ax: NamedSharding(
        mesh, partition_spec(tuple(x.shape), ax, mesh, rules)),
        tree, axes_tree)


def _spec_parts(spec: tuple, ndim: int) -> list[tuple[int, tuple]]:
    """(dim, axes) of every sharded dim of ``spec``."""
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return [(d, (part,) if isinstance(part, str) else tuple(part))
            for d, part in enumerate(spec) if part is not None]


def _unmentioned(spec: tuple, mesh) -> tuple[str, ...]:
    named = {a for _, axes in _spec_parts(spec, len(spec)) for a in axes}
    return tuple(a for a in mesh.axis_names if a not in named)


def _trimmed(spec: tuple) -> tuple:
    """``spec`` without its trailing ``None``s (``P``'s equality)."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def _split(spec: tuple, mesh) -> bool:
    """Whether ``spec`` cuts anything on ``mesh`` (an axis of size 1
    leaves the block whole)."""
    return any(mesh.axis_size(axes) > 1
               for _, axes in _spec_parts(spec, len(spec)))


def block(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of a full tensor laid out by ``spec`` (a view,
    no copy): each sharded dim is cut into ``axis_size`` even blocks and
    the rank keeps the one at its joint index over the dim's axes."""
    for d, axes in _spec_parts(spec, x.ndim):
        n = mesh.axis_size(axes)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"into {n} blocks over {axes}")
        size = x.shape[d] // n
        x = x.narrow(d, mesh.axis_index(axes) * size, size)
    return x


def _gather_blocks(local: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    for d, axes in _spec_parts(spec, local.ndim):
        if mesh.axis_size(axes) > 1:
            local = collectives._gather(local, mesh, mesh.axes(axes), d)
    return local


# The two edges of ``shard_map`` (the reference's ``in_specs`` and
# ``out_specs``), with the transposes it takes when it does not track
# replication: the cotangent of a full output is divided by the number of
# ranks that hold the same block (the axes the spec leaves out), and the
# cotangent of an input is summed over those ranks.  Every rank then ends
# with the gradient of the global function, whatever collectives ran in
# between (``psum``'s transpose is ``psum``).
#
# Trap: ``torch.distributed.nn.functional.all_gather`` would do the
# forward of ``unshard``, but its backward is a reduce-scatter *sum*.  At
# the output edge, ahead of compute that every rank runs on the same full
# tensor, every rank holds the whole cotangent already; summing it over
# the ranks multiplies the gradient by the world size.

class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh, rest):
        ctx.spec, ctx.mesh, ctx.rest = spec, mesh, rest
        return block(x, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        spec, mesh, rest = ctx.spec, ctx.mesh, ctx.rest
        if rest:
            g = collectives._psum(g, mesh, rest)
        return _gather_blocks(g, spec, mesh), None, None, None


class _Unshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, spec, mesh, rest):
        ctx.spec, ctx.mesh, ctx.rest = spec, mesh, rest
        return _gather_blocks(local, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        spec, mesh = ctx.spec, ctx.mesh
        n = math.prod(mesh.shape[a] for a in ctx.rest)
        g = block(g, spec, mesh)
        return (g / n if n != 1 else g.clone()), None, None, None


def _dim_axes(spec: tuple, d: int) -> tuple[str, ...]:
    part = spec[d] if len(spec) > d else None
    return () if part is None else (
        (part,) if isinstance(part, str) else tuple(part))


def _edge(spec: tuple, mesh, split: tuple,
          split_seq: tuple = ()) -> tuple[tuple, tuple]:
    """(the spec left to cut, the axes whose ranks hold the same block)
    of an edge whose input rows are already this rank's block over
    ``split`` and its sequence (dim 1) over ``split_seq``: dim 0's axes
    must be ``split``'s, dim 1's ``split_seq``'s."""
    spec = tuple(spec)
    for d, axes in ((0, tuple(split)), (1, tuple(split_seq))):
        if not axes:
            continue
        have = _dim_axes(spec, d)
        if have != axes:
            raise ValueError(f"dim {d} split over {axes}, the edge wants "
                             f"{have}")
        spec = spec[:d] + (None,) + spec[d + 1:]
    rest = tuple(a for a in _unmentioned(spec, mesh)
                 if a not in split and a not in split_seq)
    return spec, rest


def shard(x: torch.Tensor, spec: tuple, mesh, split: tuple = (),
          split_seq: tuple = ()) -> torch.Tensor:
    """``shard_map``'s input edge: this rank's block of the full ``x``.
    The backward gathers the full cotangent on every rank.  ``split``:
    the axes over which ``x``'s rows are this rank's block already (a
    data-parallel row's tokens), ``split_seq`` those over which its
    sequence (dim 1) is (sequence parallelism); they are neither cut nor
    summed."""
    spec, rest = _edge(spec, mesh, split, split_seq)
    return _Shard.apply(x, spec, mesh, rest)


def unshard(local: torch.Tensor, spec: tuple, mesh, split: tuple = (),
            split_seq: tuple = ()) -> torch.Tensor:
    """``shard_map``'s output edge: the full tensor from every rank's
    block (all-gathered over the spec's axes).  The backward takes this
    rank's block of the cotangent; it does not reduce-scatter.
    ``split`` and ``split_seq`` as in ``shard``."""
    spec, rest = _edge(spec, mesh, split, split_seq)
    return _Unshard.apply(local, spec, mesh, rest)


# A parameter held as blocks meets the compute in one of three ways.
# Compute that every rank runs whole on the same inputs leaves every rank
# the same whole gradient, and its block is this rank's gradient with
# nothing summed (``gather_param``).  A ``shard_map``-style function (the
# expert-parallel paths) runs on its own tokens: the ranks that hold the
# same block each hold a part of its gradient, summed over them
# (``relayout``, the input edge of ``shard_map`` for an operand that is
# blocks already).  The partitioned step's dense layers run on each
# rank's rows of the batch: ``take_param`` (below) sums the parts over
# the batch's ranks.

class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return _gather_blocks(local, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        return block(g, ctx.spec, ctx.mesh).contiguous(), None, None


class _Partial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, rest, mesh):
        ctx.rest, ctx.mesh = rest, mesh
        return local.view_as(local)

    @staticmethod
    def backward(ctx, g):
        return collectives._psum(g, ctx.mesh, ctx.rest), None, None


def gather_param(local: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole leaf from this rank's block of a parameter laid out by
    ``spec``, for compute that every rank runs on the same inputs.  The
    backward keeps this rank's block of the (whole, equal on every rank)
    cotangent and sums nothing."""
    spec = tuple(spec)
    if not _split(spec, mesh):
        return local
    return _GatherParam.apply(local, spec, mesh)


def relayout(local: torch.Tensor, have: tuple, want: tuple,
             mesh) -> torch.Tensor:
    """This rank's block under ``want`` of a parameter held as its block
    under ``have`` (``()`` for the whole leaf), as ``shard_map``'s input
    edge: the backward leaves this rank the block under ``have`` of the
    gradient summed over the ranks.  Where the two layouts agree the
    block is used as it is held, and only the ranks that hold the same
    block sum their parts."""
    have, want = _trimmed(have), _trimmed(want)
    if have == want:
        rest = tuple(a for a in _unmentioned(want, mesh)
                     if mesh.shape[a] > 1)
        return _Partial.apply(local, rest, mesh) if rest else local
    return shard(gather_param(local, have, mesh), want, mesh)


def param_layout(specs: Tree, mesh, rules: dict | None = None) -> Tree:
    """The ``partition_spec`` of every ``ParamSpec`` of a spec tree: the
    layout in which a rank of ``mesh`` holds the parameters."""
    return tree_map(lambda s: partition_spec(s.shape, s.axes, mesh, rules),
                    specs)


def local_params(params: Tree, specs: Tree, mesh,
                 rules: dict | None = None) -> Tree:
    """Each leaf of full parameters cut to this rank's block by its
    ``ParamSpec``'s logical axes under ``rules`` (a view, no copy)."""
    return tree_map(lambda p, s: block(
        p, partition_spec(tuple(p.shape), s.axes, mesh, rules), mesh),
        params, specs)


# ---------------------------------------------------------------------------
# The partitioned step: each rank's share of the batch, heads, FFN,
# vocabulary and decode cache
# ---------------------------------------------------------------------------

def block_like(x: torch.Tensor, axes: tuple, mesh,
               rules: dict | None = None) -> torch.Tensor:
    """This rank's block of ``x`` laid out by its logical ``axes`` under
    ``rules`` (``partition_spec``'s: an axis that does not divide is
    dropped, none used twice)."""
    return block(x, partition_spec(tuple(x.shape), axes, mesh, rules), mesh)


def blocks_like(tree: Tree, axes_tree: Tree, mesh,
                rules: dict | None = None) -> Tree:
    """Each leaf of ``tree`` cut to this rank's block by the parallel
    tree of logical axes (a batch's ``batch_axes``, a cache's
    ``cache_axes``): the counterpart of ``shardings_like``'s layout."""
    return tree_map(lambda x, ax: block_like(x, ax, mesh, rules), tree,
                    axes_tree)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a call under a mesh splits its work.  The batch's rows are
    this rank's block over ``dp`` (the mesh axes of the "batch" rule that
    the global batch divides over); the tensor-parallel layers (heads,
    FFN, vocabulary, the decode cache's slots) split over ``tp``
    ("model", None where the mesh has no such axis or it has one rank);
    ``cache_len`` is the global slot count of a decode cache and
    ``seq_len`` the global length of the inputs' sequence (the rank's
    block says neither whether it was cut).  ``sp``: the rules lay the
    sequence over ``tp`` (Megatron sequence parallelism), which then
    cuts every sequence that ``cuts_seq``."""
    mesh: Any
    dp: tuple[str, ...]
    tp: str | None
    cache_len: int | None = None
    seq_len: int | None = None
    sp: bool = False

    @property
    def tp_size(self) -> int:
        return self.mesh.shape[self.tp] if self.tp else 1

    @property
    def tp_index(self) -> int:
        return self.mesh.axis_index(self.tp) if self.tp else 0

    @property
    def dp_live(self) -> tuple[str, ...]:
        """``dp`` without its axes of one rank."""
        return tuple(a for a in self.dp if self.mesh.shape[a] > 1)

    def cuts_seq(self, n: int) -> bool:
        """Whether a sequence of ``n`` positions is cut over ``tp``, as
        ``partition_spec`` cuts a (B, S, D) activation laid out by
        ("batch", "seq", None): the rules lay it there, and ``n`` is
        longer than one and divides."""
        return self.sp and n > 1 and n % self.tp_size == 0


def plan(mesh, rules: dict | None = None, *, batch: int | None = None,
         cache_len: int | None = None,
         seq_len: int | None = None) -> Plan | None:
    """The :class:`Plan` of a call under ``mesh`` (a ``Mesh``, or a
    ``Plan`` returned as it is but for the counts given, ``None`` for no
    mesh).  ``batch``: the global batch, whose rows split over the
    "batch" rule's axes that divide it; without it, over all of them (a
    rank's share of a batch that divides).  ``seq_len``: the global
    length of the inputs' sequence (tokens or frames), which a
    sequence-parallel call needs (``Plan.sp``)."""
    if mesh is None or isinstance(mesh, Plan):
        counts = {k: v for k, v in (("cache_len", cache_len),
                                    ("seq_len", seq_len)) if v is not None}
        if isinstance(mesh, Plan) and counts:
            return dataclasses.replace(mesh, **counts)
        return mesh
    rules = {**DEFAULT_RULES, **(rules or {})}
    if batch is None:
        dp = _mesh_axes_for("batch", rules, mesh)
    else:
        spec = partition_spec((batch,), ("batch",), mesh, rules)
        dp = () if not spec else (
            (spec[0],) if isinstance(spec[0], str) else tuple(spec[0]))
    tp = "model" if mesh.shape.get("model", 1) > 1 else None
    seq = tuple(a for a in _mesh_axes_for("seq", rules, mesh)
                if mesh.shape[a] > 1 and a not in dp)
    if seq and seq != (tp,):
        raise ValueError(f"the sequence over {seq}: only over the "
                         f"tensor-parallel axis {tp!r} is supported")
    return Plan(mesh, tuple(dp), tp, cache_len, seq_len, bool(seq))


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, gathered, scatter, summed, mesh):
        ctx.args = (gathered, scatter, summed, mesh)
        if not gathered:
            return local.view_as(local)
        for d, axes in gathered:
            local = collectives._gather(local, mesh, axes, d)
        return local

    @staticmethod
    def backward(ctx, g):
        gathered, scatter, summed, mesh = ctx.args
        if summed:
            g = collectives._psum(g, mesh, summed)
        for d, axes in gathered:
            if axes in scatter:
                g = collectives._scatter(g, mesh, axes, d)
            else:
                g = block(g, (None,) * d + (axes,), mesh)
        return g.contiguous(), None, None, None, None


def take_param(local: torch.Tensor, spec: tuple, plan_: Plan,
               whole: bool = False, sliced: bool = False) -> torch.Tensor:
    """A dense parameter leaf for this rank's compute, from the block it
    holds laid out by ``spec``: gathered over every axis but the
    tensor-parallel one (FSDP's per-layer gather), or with ``whole``
    over every axis (a layer that runs whole on each rank of "model").
    The backward leaves the block the gradient summed over the ranks of
    ``plan_.dp``, each of which computed its rows' part:
    reduce-scattered over the axes it was gathered over, summed over the
    others.  ``sliced``: the leaf is applied to this rank's block of the
    sequence (a norm under sequence parallelism), so the ranks of
    ``plan_.tp`` each computed a part of its gradient too, summed over
    them."""
    mesh = plan_.mesh
    gathered = []
    for d, axes in _spec_parts(tuple(spec), local.ndim):
        live = tuple(a for a in axes if mesh.shape[a] > 1)
        if not live:
            continue
        if plan_.tp in live and not whole:
            if live != (plan_.tp,):
                raise ValueError(f"dim {d} of a leaf laid out by {spec} "
                                 f"mixes {plan_.tp!r} with other axes")
            continue
        gathered.append((d, live))
    dp = set(plan_.dp_live)
    scatter = tuple(axes for _, axes in gathered if set(axes) <= dp)
    parts = plan_.dp_live + ((plan_.tp,) if sliced and plan_.tp else ())
    summed = tuple(a for a in parts
                   if not any(a in axes for axes in scatter))
    if not gathered and not summed:
        return local
    if not torch.is_grad_enabled() or not local.requires_grad:
        for d, axes in gathered:
            local = collectives._gather(local, mesh, axes, d)
        return local
    return _Take.apply(local, tuple(gathered), scatter, summed, mesh)


def take_params(tree: Tree, layout: Tree, plan_: Plan,
                whole: bool = False, sliced: bool = False) -> Tree:
    """``take_param`` over a tree and its layout."""
    return tree_map(lambda t, spec: take_param(t, spec, plan_, whole,
                                               sliced), tree, layout)
