"""The collectives of ``jax.lax`` over a :class:`~repro_torch.launch.mesh.
Mesh`'s axes, under autograd.

Each takes ``axes`` (a name or a tuple of names) and runs in the mesh's
process group over them; ``axes=()`` names no axis and returns its input.
The gathers and exchanges are ``tiled``: ``all_gather`` concatenates the
ranks' blocks along ``dim`` in the order of their joint index,
``psum_scatter`` sums and leaves each rank its block of ``dim``, and
``all_to_all`` cuts ``split_dim`` into one chunk per rank and
concatenates what it receives along ``concat_dim``.  Their backwards are
the transposes ``shard_map`` uses: ``psum`` -> ``psum``, ``all_gather``
<-> ``psum_scatter``, and ``all_to_all`` with the two dims swapped.
Integer tensors cross without a graph (the int8 wire).

``wire_tally()`` counts what crosses: while it is open, every collective
this process issues (forward, recompute and backward alike, each loop
iteration as it runs) adds the bytes of its result to its kind, as the
reference's HLO parse (``roofline.analysis.collective_bytes``) reads
them: an all-reduce its input's size, an all-gather the gathered size,
a reduce-scatter the scattered size, an all-to-all its input's size,
and ``dist.pipeline``'s ring shift a collective-permute of what it
receives.  ``replicate``'s broadcast, which the reference's kinds lack,
is a kind of its own.  Closed, the tally costs one test of a module global per
collective.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute", "broadcast")


class WireTally:
    """Bytes of the results and counts of the collectives, by kind."""

    def __init__(self):
        self.bytes = dict.fromkeys(KINDS, 0)
        self.count = dict.fromkeys(KINDS, 0)

    def add(self, kind: str, t: torch.Tensor) -> None:
        self.bytes[kind] += t.numel() * t.element_size()
        self.count[kind] += 1


_tally: WireTally | None = None


@contextlib.contextmanager
def wire_tally():
    """A fresh :class:`WireTally` of the collectives issued inside."""
    global _tally
    outer, _tally = _tally, WireTally()
    try:
        yield _tally
    finally:
        _tally = outer


def _ordered(mesh, axes) -> tuple[str, ...]:
    """A reduction's axes in mesh order (a sum does not depend on it)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(sorted(axes, key=mesh.axis_names.index))


def _psum(x, mesh, axes):
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.group(axes))
    if _tally is not None:
        _tally.add("all-reduce", y)
    return y


def _gather(x, mesh, axes, dim):
    n = mesh.axis_size(axes)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=mesh.group(axes))
    if _tally is not None:
        _tally.add("all-gather", out)
    return out.movedim(0, dim)


def _scatter(x, mesh, axes, dim):
    n = mesh.axis_size(axes)
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, op=dist.ReduceOp.SUM,
                               group=mesh.group(axes))
    if _tally is not None:
        _tally.add("reduce-scatter", out)
    return out.movedim(0, dim)


def _exchange(x, mesh, axes, split_dim, concat_dim):
    n = mesh.axis_size(axes)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    xt = x.movedim(split_dim, 0).contiguous()
    out = torch.empty_like(xt)
    dist.all_to_all_single(out, xt, group=mesh.group(axes))
    if _tally is not None:
        _tally.add("all-to-all", out)
    c = xt.shape[0] // n
    chunks = out.view((n, c) + tuple(xt.shape[1:])).movedim(1, split_dim + 1)
    return torch.cat(chunks.unbind(0), dim=concat_dim)


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        y = x.contiguous().clone()
        group = mesh.group(axes)
        dist.broadcast(y, src=dist.get_global_rank(group, 0), group=group)
        if _tally is not None:
            _tally.add("broadcast", y)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _psum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, split_dim, concat_dim):
        ctx.args = (mesh, axes, split_dim, concat_dim)
        return _exchange(x, mesh, axes, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, split_dim, concat_dim = ctx.args
        return _exchange(g, mesh, axes, concat_dim, split_dim), \
            None, None, None, None


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    axes = _ordered(mesh, axes)
    if not axes:
        return x
    return _PSum.apply(x, mesh, axes)


def replicate(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Every rank of ``axes`` takes the bits of the one at index 0, for
    a value they all computed as the same function of the same inputs
    but may have rounded apart (a ``psum_scatter``'s sums run in
    rank-dependent orders).  The backward is the identity: each rank
    keeps its own cotangent, as for the value it computed."""
    axes = mesh.axes(axes)
    if not axes:
        return x
    return _Replicate.apply(x, mesh, axes)


def pmean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    axes = _ordered(mesh, axes)
    if not axes:
        return x
    return psum(x, mesh, axes) / mesh.axis_size(axes)


def all_gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    axes = mesh.axes(axes)
    if not axes:
        return x
    if not x.is_floating_point():
        return _gather(x, mesh, axes, dim % x.ndim)
    return _AllGather.apply(x, mesh, axes, dim % x.ndim)


def psum_scatter(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    axes = mesh.axes(axes)
    if not axes:
        return x
    return _PSumScatter.apply(x, mesh, axes, dim % x.ndim)


def all_to_all(x: torch.Tensor, mesh, axes, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    axes = mesh.axes(axes)
    if not axes:
        return x
    if not x.is_floating_point():
        return _exchange(x, mesh, axes, split_dim % x.ndim,
                         concat_dim % x.ndim)
    return _AllToAll.apply(x, mesh, axes, split_dim % x.ndim,
                           concat_dim % x.ndim)
