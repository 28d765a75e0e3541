"""The LM's training and evaluation steps: gradient accumulation over
microbatches, then the AdamW update.

Counterpart of ``repro.train.train_loop``.  ``build_train_step(cfg,
mesh=None, ...)`` returns

    step(params, opt_state, batch) -> (params, opt_state, metrics)

with ``batch`` already split into microbatches (``microbatch``, outside
the step, as the reference's note asks): every leaf (n_micro, B /
n_micro, ...).  Each microbatch's gradient is taken through
``lm.loss_fn`` under autograd (the plain blockwise attention, no flash
kernel), cast to ``grad_dtype`` and summed in microbatch order, then
divided by ``n_micro``; the loss likewise.  ``metrics`` holds ``loss``,
``grad_norm`` (before clipping) and ``lr``, device scalars.
``build_eval_step`` runs ``lm.loss_fn`` under ``torch.no_grad()``, so
on the card its attention is the flash kernel.  With a ``mesh``
(``launch.mesh``, or an ``nn.module.Plan``) every rank of it calls the
step on its blocks of the parameters and optimizer state
(``nn.module.param_layout``) and its share of the batch: each
microbatch's rows of this rank, (n_micro, mb / dp, ...), the global
microbatch cut over the mesh's "batch" axes, and its block of the
sequence where the config's overrides put it over "model" (then the
``mesh`` is a ``Plan`` with the sequence's global length,
``nn.module.plan(..., seq_len=)``).  ``lm.loss_fn(mesh=)``
gives each rank its blocks of the global gradient (summed over the ranks
of the batch's axes: reduce-scattered onto FSDP's blocks, summed where
a leaf is whole over them), the clipping norm is the whole gradient's
(``block_norm``), and each rank updates its blocks with AdamW.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import f32math
from repro_torch.dist import collectives
from repro_torch.models import lm
from repro_torch.nn import module
from repro_torch.nn.module import leaves, tree_map, unflatten
from repro_torch.train import optim

Tree = Any


def microbatch(batch: dict, n_micro: int) -> dict:
    """(B, ...) -> (n_micro, B / n_micro, ...), every leaf."""
    def split(x):
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"a batch of {b} does not split into {n_micro} "
                             "microbatches")
        return x.reshape(n_micro, b // n_micro, *x.shape[1:])
    return {k: split(v) for k, v in batch.items()}


def block_norm(grads: Tree, cfg: lm.LMConfig, mesh) -> torch.Tensor:
    """The global norm of the whole gradient from this rank's blocks:
    each leaf's sum of squares summed over the axes its layout cuts (the
    ranks that hold its other blocks; the ranks that hold the same block
    hold the same gradient, and it counts once), then over the leaves in
    ``optim.global_norm``'s order, which it equals on one rank."""
    mesh = module.plan(mesh).mesh
    layout = leaves(module.param_layout(lm.param_specs(cfg), mesh,
                                        cfg.sharding_overrides))
    total = None
    for g, spec in zip(leaves(grads), layout):
        axes = tuple(a for part in spec if part is not None
                     for a in ((part,) if isinstance(part, str) else part)
                     if mesh.shape[a] > 1)
        sq = torch.sum(torch.square(g.float()))
        if axes:
            sq = collectives.psum(sq, mesh, axes)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def build_train_step(cfg: lm.LMConfig, mesh=None, *, n_micro: int = 1,
                     opt_cfg: optim.AdamWConfig | None = None,
                     grad_dtype: torch.dtype = torch.float32):
    opt_cfg = opt_cfg or optim.AdamWConfig()

    def train_step(params, opt_state, batch):
        lead = next(iter(batch.values())).shape[0]
        if lead != n_micro:
            raise ValueError(f"the batch holds {lead} microbatches, the "
                             f"step takes {n_micro}")
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        flat = leaves(live)
        g_acc, loss_sum = None, None
        for i in range(n_micro):
            loss, _ = lm.loss_fn(live, {k: v[i] for k, v in batch.items()},
                                 cfg, mesh=mesh)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
            grads = [(torch.zeros_like(p) if g is None else g).to(grad_dtype)
                     for p, g in zip(flat, grads)]
            g_acc = grads if g_acc is None else [
                a + g for a, g in zip(g_acc, grads)]
            loss_sum = loss.detach() if loss_sum is None \
                else loss_sum + loss.detach()
        with torch.no_grad():
            grads = unflatten(params, [f32math.div(g, float(n_micro))
                                        for g in g_acc])
            gnorm = None if mesh is None else block_norm(grads, cfg, mesh)
            params, opt_state, stats = optim.adamw_update(
                grads, opt_state, params, opt_cfg, gnorm)
        return params, opt_state, {
            "loss": f32math.div(loss_sum, float(n_micro)), **stats}

    return train_step


def build_eval_step(cfg: lm.LMConfig, mesh=None):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, parts = lm.loss_fn(params, batch, cfg, mesh=mesh)
        return {"loss": loss, **parts}
    return eval_step
