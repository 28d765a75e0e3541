"""Optimizers: AdamW and SGD with momentum, global gradient-norm
clipping, the warmup + cosine schedule.

Counterpart of ``repro.train.optim``, on trees of nested dicts of
tensors, with its f32 arithmetic in the reference's order: the schedule
divides the int32 step (plus one) in f32 and takes the C library's f32
cosine as the reference does (``core.f32math.cosf``; ``torch.cos`` moves
one value in thirty by an ULP), ``b1 ** step`` is an f32 power,
every division by a number goes through ``core.f32math.div`` (PyTorch's
CUDA kernels multiply by the reciprocal), the global norm sums the
leaves in sorted-key order (``jax.tree.leaves``'), and weight decay goes
to every leaf of two or more dimensions, so the stacked norm scales of a
layer group (G, D) are decayed as the reference decays them.  Moments
are kept in ``moment_dtype`` (bf16 halves their memory).

The reference's ``scan_subtrees`` (updating a stacked subtree group by
group to bound its f32 temporaries) is not carried over: its train step
does not use it, and the update is elementwise, so it changes no value.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.core import f32math
from repro_torch.nn.module import leaves, tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"   # "bfloat16" halves optimizer memory


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar: updates applied so far
    mu: Tree
    nu: Tree


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def adamw_init(params: Tree, cfg: AdamWConfig) -> AdamWState:
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    first = leaves(params)[0]

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return AdamWState(torch.zeros((), dtype=torch.int32, device=first.device),
                      tree_map(zeros, params), tree_map(zeros, params))


def schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """The learning rate at ``step`` (int32 scalar), f32: linear warmup
    over ``warmup_steps``, then a cosine down to ``min_lr_frac``."""
    warm = torch.clamp(f32math.div((step + 1).float(),
                                   float(max(cfg.warmup_steps, 1))), max=1.0)
    t = torch.clamp(f32math.div(
        (step - cfg.warmup_steps).float(),
        float(max(cfg.total_steps - cfg.warmup_steps, 1))), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + f32math.cosf(_f32(math.pi, t) * t))
    return _f32(cfg.lr, t) * warm * cos


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (f32), the leaves summed
    in sorted-key order."""
    total = None
    for x in leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tree, max_norm: float,
                        gnorm: torch.Tensor | None = None):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping).  ``gnorm`` is the norm where the caller reckons it
    (a rank's blocks of the gradient under a mesh)."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(f32math.div(_f32(max_norm, gnorm), gnorm + 1e-9),
                        max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


def adamw_apply(grads: Tree, mu: Tree, nu: Tree, params: Tree,
                step: torch.Tensor, lr: torch.Tensor, cfg: AdamWConfig):
    """The elementwise AdamW update (clipping and schedule done by the
    caller): (params, mu, nu), each in its own dtype."""
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    c1 = 1 - torch.pow(_f32(b1, stepf), stepf)
    c2 = 1 - torch.pow(_f32(b2, stepf), stepf)

    def upd(g, m, v, p):
        gf = g.float()
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf * gf
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
        if p.ndim >= 2:   # decay matrices only (norms and biases exempt)
            delta = delta + cfg.weight_decay * p.float()
        p_new = p.float() - lr * delta
        return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

    out = tree_map(upd, grads, mu, nu, params)
    return tuple(tree_map(lambda o, i=i: o[i], out) for i in range(3))


def adamw_update(grads: Tree, state: AdamWState, params: Tree,
                 cfg: AdamWConfig, gnorm: torch.Tensor | None = None):
    """Clip, schedule, update: (params, state, {"grad_norm", "lr"});
    ``gnorm`` as in ``clip_by_global_norm``."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, gnorm)
    step = state.step + 1
    lr = schedule(state.step, cfg)
    p_new, mu, nu = adamw_apply(grads, state.mu, state.nu, params, step, lr,
                                cfg)
    return p_new, AdamWState(step, mu, nu), {"grad_norm": gnorm, "lr": lr}


# --- SGD (for the SNN experiments) -----------------------------------------

class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: Tree


def sgd_init(params: Tree) -> SGDState:
    first = leaves(params)[0]
    return SGDState(torch.zeros((), dtype=torch.int32, device=first.device),
                    tree_map(torch.zeros_like, params))


def sgd_update(grads: Tree, state: SGDState, params: Tree, lr: float = 1e-2,
               momentum: float = 0.9):
    mom = tree_map(lambda m, g: momentum * m + g, state.momentum, grads)
    params = tree_map(lambda p, m: p - lr * m, params, mom)
    return params, SGDState(state.step + 1, mom)
