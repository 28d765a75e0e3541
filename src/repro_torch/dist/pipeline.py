"""GPipe pipeline parallelism over one mesh axis.

Counterpart of ``repro.dist.pipeline``.  Each rank along ``stage_axis``
runs one pipeline stage, with its stage's slice of the parameters (the
leading stage dim of every leaf).  The schedule is GPipe's fill, steady
and drain loop: ``n_micro + n_stages - 1`` ticks, in each of which every
stage runs its microbatch and sends the activation to the next stage on
a ring of ``batch_isend_irecv`` (the reference's ``ppermute``).  The
bubble is the fill and drain: ``bubble_fraction``, (S - 1) / (M + S - 1).
Forward only, as the reference's test uses it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist import collectives
from repro_torch.nn.module import tree_map


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    """GPipe bubble overhead: (S-1) idle ticks out of (M+S-1) total."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _ring(y: torch.Tensor, mesh, stage_axis: str) -> torch.Tensor:
    """``y`` to the next stage, the previous stage's ``y`` back (a ring
    of one stage is the identity)."""
    n = mesh.shape[stage_axis]
    if n == 1:
        return y
    coords = mesh.coords_of(mesh.rank)
    stage = coords[stage_axis]
    nxt = mesh.rank_of({**coords, stage_axis: (stage + 1) % n})
    prv = mesh.rank_of({**coords, stage_axis: (stage - 1) % n})
    y = y.contiguous()
    recv = torch.empty_like(y)
    group = mesh.group(stage_axis)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, y, nxt, group),
                                   dist.P2POp(dist.irecv, recv, prv, group)])
    for r in reqs:
        r.wait()
    if collectives._tally is not None:
        collectives._tally.add("collective-permute", recv)
    return recv


@torch.no_grad()
def gpipe(stage_fn, params, x_mb: torch.Tensor, mesh,
          stage_axis: str = "pod") -> torch.Tensor:
    """Run ``n_micro`` microbatches through the stage pipeline.

    stage_fn: (stage_params, x) -> y, the per-stage forward.
    params:   a tree of nested dicts whose leaves carry a leading
              (n_stages, ...) dim; this rank uses its stage's slice.
    x_mb:     (n_micro, ...) microbatches, the same on every rank.

    Returns the (n_micro, ...) outputs after all stages, on every rank.
    """
    n_stages = mesh.shape[stage_axis]
    n_micro = x_mb.shape[0]
    stage = mesh.axis_index(stage_axis)
    p_my = tree_map(lambda a: a[stage], params)
    last = stage == n_stages - 1
    outs = torch.zeros_like(x_mb)
    recv = torch.zeros_like(x_mb[0])
    for t in range(n_micro + n_stages - 1):
        # stage 0 injects microbatch t (the drain's clipped reads are
        # computed but never reach the last stage inside the loop)
        x_in = x_mb[min(t, n_micro - 1)] if stage == 0 else recv
        y = stage_fn(p_my, x_in)
        out_idx = t - (n_stages - 1)
        if last and out_idx >= 0:
            outs[out_idx] = y
        recv = _ring(y, mesh, stage_axis)
    if not last:
        outs = torch.zeros_like(outs)
    # only the last stage holds results; the sum replicates them
    return collectives.psum(outs, mesh, stage_axis)
