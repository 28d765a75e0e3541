"""Mixture-of-Experts: the router and the dense-combine reference.

The router *is* a K-winner circuit (paper C3): top-k expert selection over
the router logits is exactly the KWN selection the macro performs over its
columns, with the same optional SNL-style probabilistic rescue of
near-threshold experts (a beyond-paper ablation).

Counterpart of the single-device half of ``repro.nn.moe``: ``moe_specs``,
``router_topk``, ``_expert_ffn``, ``aux_load_balance_loss`` and
``moe_ref``, the function the reference computes with no mesh.  Its
expert-parallel paths (``moe_a2a``, ``moe_2d``, ``moe_dense_ep`` and
their dispatch) need a process group over several cards and come with the
distributed slice.

The top-k keeps the reference's order among equal values (the lower
index first, as ``jax.lax.top_k``): a stable descending sort, where
``torch.topk`` promises no order.  Where the reference draws the rescue's
Gumbel sample from a key, the port takes the sample as a tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn import layers
from repro_torch.nn.module import ParamSpec

# Elements of one expert chunk's largest intermediate in ``moe_ref``: the
# experts run in chunks so that the (experts, tokens, width) products stay
# near this size whatever the expert count (a kimi-k2 prefill of 1024
# tokens would otherwise hold 5.6 GB of expert outputs at once).
CHUNK_ELEMENTS = 1 << 30


def moe_specs(d_model: int, d_ff: int, n_experts: int,
              dtype=torch.float32, router_dtype=torch.float32) -> dict:
    return {
        "router": ParamSpec((d_model, n_experts), ("embed", None),
                            router_dtype, scale=0.02),
        "w_in": ParamSpec((n_experts, d_model, d_ff),
                          ("experts", "expert_in", "expert_ffn"), dtype),
        "w_gate": ParamSpec((n_experts, d_model, d_ff),
                            ("experts", "expert_in", "expert_ffn"), dtype),
        "w_out": ParamSpec((n_experts, d_ff, d_model),
                           ("experts", "expert_ffn", "expert_in"), dtype),
    }


def _topk_lower_index_first(x: torch.Tensor, k: int):
    """The k largest along the last axis, descending, the lower index
    first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_topk(logits: torch.Tensor, k: int, *, snl_rescue: float = 0.0,
                gumbel: torch.Tensor | None = None):
    """KWN selection over expert logits: (gates renormalised over the k
    winners, winner indices, the f32 softmax probabilities).

    ``snl_rescue > 0`` with a ``gumbel`` sample of the probabilities'
    shape enables the SNL analogue: experts whose probability lands
    within ``snl_rescue`` of the k-th winner's get a kick of
    ``snl_rescue * gumbel / 2``, which may let them displace it."""
    probs = torch.softmax(logits.float(), dim=-1)
    if snl_rescue > 0.0 and gumbel is not None:
        kth = torch.sort(probs, dim=-1).values[..., -k][..., None]
        band = (probs > kth - snl_rescue) & (probs < kth + snl_rescue)
        kick = snl_rescue * gumbel.to(probs.dtype) * 0.5
        probs = torch.where(band, probs + kick, probs)
    gate, idx = _topk_lower_index_first(probs, k)
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)
    return gate, idx, probs


def _expert_ffn(w_in, w_gate, w_out, x, activation):
    """Each expert's gated FFN on its rows: x (E, C, D), or (1, C, D)
    for the same rows into every expert -> (E, C, D)."""
    act = layers.ACTIVATIONS[activation]
    h = act(torch.matmul(x, w_in.to(x.dtype)))
    g = torch.matmul(x, w_gate.to(x.dtype))
    return torch.matmul(h * g, w_out.to(x.dtype))


def aux_load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                          n_experts: int, k: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss."""
    lead = tuple(range(probs.ndim - 1))
    me = torch.mean(probs, dim=lead)
    assign = F.one_hot(idx, n_experts).to(torch.float32).sum(-2)
    ce = torch.mean(assign, dim=lead) / k
    return n_experts * torch.sum(me * ce)


def route(p: dict, x: torch.Tensor, k: int, *, snl_rescue: float = 0.0,
          gumbel: torch.Tensor | None = None):
    """``router_topk`` over x (..., D)'s router logits, the router cast
    to x's dtype as the reference does."""
    return router_topk(x @ p["router"].to(x.dtype), k,
                       snl_rescue=snl_rescue, gumbel=gumbel)


def combine_weights(gate: torch.Tensor, idx: torch.Tensor, n_experts: int,
                    dtype) -> torch.Tensor:
    """(T, E): each token's gate on each of its k experts, 0 on the
    rest, in ``dtype``."""
    w = F.one_hot(idx, n_experts).to(dtype) * gate[..., None].to(dtype)
    return w.sum(-2).reshape(-1, n_experts)


def run_experts(p: dict, xt: torch.Tensor, e0: int, e1: int,
                activation: str) -> torch.Tensor:
    """Experts [e0, e1) on every token of xt (1, T, D) -> (e1 - e0, T,
    D)."""
    return _expert_ffn(p["w_in"][e0:e1], p["w_gate"][e0:e1],
                       p["w_out"][e0:e1], xt, activation)


def combine_chunk(combine: torch.Tensor, outs: torch.Tensor) -> torch.Tensor:
    """One chunk's share of the output: the reference's ``einsum`` of its
    experts' combine weights (T, c) with their outputs (c, T, D), in
    f32."""
    return torch.einsum("te,etd->td", combine, outs).float()


def moe_ref(p: dict, x: torch.Tensor, *, k: int, activation: str = "silu",
            snl_rescue: float = 0.0, gumbel: torch.Tensor | None = None,
            with_aux: bool = True):
    """Dense-combine reference: every expert runs on every token, and
    each token sums its experts' outputs weighted by its gates.  x (...,
    D) -> (y (..., D), aux loss f32, or None where ``with_aux`` is
    false: a decode step's, which the reference discards).

    The experts run in chunks of at most ``CHUNK_ELEMENTS`` elements of
    output, the tokens shared by every expert of a chunk (no copy per
    expert); each chunk's combine is the reference's ``einsum`` over its
    experts, the chunks summed in f32 (one chunk keeps its bits)."""
    gate, idx, probs = route(p, x, k, snl_rescue=snl_rescue, gumbel=gumbel)
    n_experts = p["w_in"].shape[0]
    lead, d = x.shape[:-1], x.shape[-1]
    xt = x.reshape(1, -1, d)                                 # (1, T, D)
    combine = combine_weights(gate, idx, n_experts, x.dtype)  # (T, E)
    y = None
    for e0, e1 in expert_chunks(n_experts, xt.shape[1],
                                max(d, p["w_in"].shape[-1])):
        part = combine_chunk(combine[:, e0:e1],
                             run_experts(p, xt, e0, e1, activation))
        y = part if y is None else y + part
    aux = aux_load_balance_loss(probs, idx, n_experts, k) if with_aux \
        else None
    return y.to(x.dtype).reshape(*lead, d), aux


def expert_chunks(n_experts: int, n_tokens: int,
                  width: int) -> list[tuple[int, int]]:
    """``moe_ref``'s expert ranges [e0, e1): as many experts a chunk as
    keep its (experts, tokens, width) intermediates within
    ``CHUNK_ELEMENTS``, at least one."""
    step = max(1, CHUNK_ELEMENTS // max(1, n_tokens * width))
    return [(e0, min(n_experts, e0 + step))
            for e0 in range(0, n_experts, step)]
