"""Device meshes over ``torch.distributed``.

Counterpart of ``repro.launch.mesh``.  A :class:`Mesh` names the axes of
a grid of ranks (``mesh.shape["model"]``), gives this rank's coordinate
on each (``axis_index``), and holds one process group for every subset
of its axes, the groups a ``psum``, ``all_gather``, ``psum_scatter`` or
``all_to_all`` over those axes runs in.  Ranks are laid out row-major
over the axes, and a group's ranks are in the order of the axes' joint
index (the first axis major), which is ``jax.lax.axis_index``'s order
over a tuple of axes.

``dist.new_group`` must be called by every rank of the world, for every
group, in the same order, so the constructor makes all of them at once
(a group made later inside one branch of a path would deadlock the ranks
that do not take it).  The process group is the caller's: on the card
``init_process_group("nccl")``, on the CPU ``"gloo"``, and
``"cpu:gloo,cuda:nccl"`` where one process runs collectives on both.
``mesh=None`` in the models means one device and no collective.

Launch several cards with ``torchrun --nproc-per-node N``: each process
calls ``torch.cuda.set_device(local_rank)``, ``dist.init_process_group(
"nccl")`` and then ``make_host_mesh()``.
"""

from __future__ import annotations

import itertools
import math

import torch.distributed as dist


class Mesh:
    """Named axes over the ranks of the default process group."""

    def __init__(self, shape, axis_names):
        shape = tuple(int(n) for n in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) \
                != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.size = math.prod(shape)
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"a mesh of {self.size} ranks over a world "
                             f"of {world}")
        self.rank = dist.get_rank()
        self._coords = self.coords_of(self.rank)
        self._groups: dict[tuple[str, ...], object] = {}
        self._make_groups()

    def coords_of(self, rank: int) -> dict[str, int]:
        """The coordinates of ``rank`` (row-major over the axes)."""
        out = {}
        for name in reversed(self.axis_names):
            rank, out[name] = divmod(rank, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def rank_of(self, coords: dict[str, int]) -> int:
        r = 0
        for name in self.axis_names:
            r = r * self.shape[name] + coords[name]
        return r

    def _make_groups(self) -> None:
        """One group per nonempty subset of the axes and per coordinate
        of the others, in a fixed order on every rank; each takes the
        default group's backends."""
        names = self.axis_names
        for n in range(1, len(names) + 1):
            for subset in itertools.combinations(names, n):
                rest = [a for a in names if a not in subset]
                mine = None
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in rest)):
                    base = dict(zip(rest, fixed))
                    ranks = [self.rank_of({**base, **dict(zip(subset, c))})
                             for c in itertools.product(
                                 *(range(self.shape[a]) for a in subset))]
                    if len(ranks) == dist.get_world_size():
                        g = dist.group.WORLD
                    else:
                        g = dist.new_group(ranks)
                    if self.rank in ranks:
                        mine = g
                self._groups[subset] = mine

    def axes(self, axes) -> tuple[str, ...]:
        """``axes`` (a name or a tuple of names) as a tuple of this
        mesh's axes in mesh order; an axis the mesh lacks raises, and so
        does a tuple out of mesh order (its joint index would not be the
        group's)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"no axis {a!r} in mesh {self.axis_names}")
        if list(axes) != sorted(axes, key=self.axis_names.index):
            raise ValueError(f"axes {axes} out of the mesh's order "
                             f"{self.axis_names}")
        return axes

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's joint index over ``axes`` (the first axis major),
        ``jax.lax.axis_index``."""
        i = 0
        for a in self.axes(axes):
            i = i * self.shape[a] + self._coords[a]
        return i

    def group(self, axes):
        """The process group of this rank over ``axes``."""
        return self._groups[self.axes(axes)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16 x 16 = 256 ranks ("data", "model").  Multi-pod: 2
    pods of 256 = 512 ranks ("pod", "data", "model").  Raises unless the
    world has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks, the world has {world}")
    return Mesh(shape, axes)


def make_host_mesh() -> Mesh:
    """A (1, world) ("data", "model") mesh over every rank of the world
    (tests, examples and one card)."""
    return Mesh((1, dist.get_world_size()), ("data", "model"))
