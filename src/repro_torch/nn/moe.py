"""Mixture-of-Experts: the router and the dense-combine reference.

The router *is* a K-winner circuit (paper C3): top-k expert selection over
the router logits is exactly the KWN selection the macro performs over its
columns, with the same optional SNL-style probabilistic rescue of
near-threshold experts (a beyond-paper ablation).

Counterpart of ``repro.nn.moe``: ``moe_specs``, ``router_topk``,
``_expert_ffn``, ``aux_load_balance_loss`` and ``moe_ref``, the function
the reference computes with no mesh, and its expert-parallel paths over
a :class:`~repro_torch.launch.mesh.Mesh`:

* ``moe_a2a``: tokens sharded over the token axes and sliced over the
  expert axis, capacity-based dispatch (``_dispatch_onehot``), two
  ``all_to_all``s over the expert axis, batched per-expert GEMMs;
* ``moe_2d``: experts over the DP rows and their FFN width over the TP
  axis (the 1T-scale path), optionally with an int8 wire
  (``_wire_quantize``); its post-exchange tokens are what the LM's
  "save_moe_recv" remat policy keeps (``pinned_recv_contexts``);
* ``moe_dense_ep`` / ``moe_dense_ep_2d``: the decode shapes, every local
  expert on every local token, combined with a ``psum``.

Each has ``shard_map``'s semantics: the full ``x`` in, the full ``y``
and a scalar ``aux`` out, on every rank (``nn.module.shard`` /
``unshard`` at the edges), and inside a function of the rank's block
with the collectives of ``dist.collectives``, under autograd.  The
parameters come as the rank holds them: ``specs`` names each leaf's
layout (``nn.module.param_layout``, the blocks ``local_params`` and
``checkpoint.restore(shardings=)`` give), or ``None`` for whole leaves
on every rank; ``nn.module.relayout`` cuts the path's blocks from them,
and where the layouts agree (the experts of a config's own overrides)
the blocks are used as held, so no rank holds every expert.  The
token-to-rank assignment, the queue order and each path's ``aux``
estimator (the ``pmean``s over the axes it uses) are the reference's, so
capacity drops fall on the same assignments.

The top-k keeps the reference's order among equal values (the lower
index first, as ``jax.lax.top_k``): a stable descending sort, where
``torch.topk`` promises no order.  Where the reference draws the rescue's
Gumbel sample from a key, the port takes the sample as a tensor.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as col
from repro_torch.nn import layers
from repro_torch.nn.module import ParamSpec, relayout, shard, unshard

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


# ---------------------------------------------------------------------------
# Expert-parallel paths
# ---------------------------------------------------------------------------

def _queue_positions(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each assignment's place in its expert's queue, token-major (the
    reference's cumsum order): idx (T, k) -> (T, k) int."""
    t, k = idx.shape
    flat = F.one_hot(idx, n_experts).to(torch.int32).reshape(t * k,
                                                             n_experts)
    pos = torch.cumsum(flat, dim=0) - flat
    return (pos * flat).sum(-1).reshape(t, k)


def _dispatch_onehot(idx, gate, n_experts, capacity, dtype):
    """Capacity-based dispatch and combine tensors from top-k routing.

    idx / gate (T, k) -> dispatch (T, E, C) of {0, 1} and combine (T, E,
    C); an assignment past its expert's ``capacity`` is dropped."""
    pos = _queue_positions(idx, n_experts)
    keep = pos < capacity
    e_oh = F.one_hot(idx, n_experts).to(dtype)                    # (T,k,E)
    pos_oh = F.one_hot(torch.where(keep, pos, torch.zeros_like(pos)),
                       capacity).to(dtype) * keep[..., None].to(dtype)
    disp = torch.einsum("tke,tkc->tec", e_oh, pos_oh)
    comb = torch.einsum("tke,tkc->tec", e_oh * gate[..., None].to(dtype),
                        pos_oh)
    return disp, comb


def _capacity(t_slice: int, k: int, n_experts: int,
              capacity_factor: float) -> int:
    return max(1, int(math.ceil(t_slice * k / n_experts * capacity_factor)))


def _record(stats, idx, capacity, n_experts) -> None:
    """The local routing into ``stats``: winners ``idx`` (T, k), which
    assignments fit their expert's queue (``kept``), the capacity and the
    number dropped on this rank."""
    if stats is None:
        return
    kept = _queue_positions(idx, n_experts) < capacity
    stats.update(idx=idx.detach(), kept=kept, capacity=capacity,
                 dropped=int((~kept).sum()))


def _spec(axes: tuple[str, ...]):
    """A tuple of axes as one spec entry (the reference's ``P(axes)``)."""
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _held(p: dict, specs: dict | None, name: str, want: tuple, mesh):
    """``p[name]``'s block under the path's layout ``want``, from the
    layout ``specs`` holds it in (``None``: the whole leaf)."""
    have = () if specs is None else specs[name]
    return relayout(p[name], have, want, mesh)


def moe_a2a(p: dict, x: torch.Tensor, *, k: int, mesh,
            activation: str = "silu", capacity_factor: float = 1.25,
            token_axes=("pod", "data"), expert_axis: str = "model",
            seq_sharded: bool = False, snl_rescue: float = 0.0,
            gumbel: torch.Tensor | None = None, stats: dict | None = None,
            specs: dict | None = None):
    """Expert-parallel MoE through ``all_to_all``: x (B, S, D) -> (y (B,
    S, D), aux).  ``p`` is held in the layout ``specs`` (module doc).

    Tokens are sharded over ``token_axes`` and further over
    ``expert_axis``: by the sequence when ``seq_sharded`` (and S divides
    over it), else each rank of the expert axis takes its ``axis_index``
    slice of its flattened tokens.  They go to their experts' owners with
    ``all_to_all``, through the batched per-expert GEMMs, and back.
    ``gumbel`` is the rescue's draw for a rank's routed tokens, the same
    on every rank (the reference's one key); ``stats`` (a dict) receives
    this rank's routing (``_record``)."""
    b, s, d = x.shape
    n_experts = p["router"].shape[-1]
    taxes = tuple(a for a in token_axes if a in mesh.shape)
    tp = mesh.shape[expert_axis]
    if seq_sharded and s % tp != 0:
        seq_sharded = False   # fall back to the slice path
    x_spec = (_spec(taxes), expert_axis if seq_sharded else None, None)
    w_spec = (expert_axis,)
    router = _held(p, specs, "router", (), mesh)
    w_in, w_gate, w_out = (_held(p, specs, n, w_spec, mesh)
                           for n in ("w_in", "w_gate", "w_out"))
    xl = shard(x, x_spec, mesh)

    bl, sl, dl = xl.shape
    t_loc = bl * sl
    xt = xl.reshape(t_loc, dl)
    if seq_sharded:
        xs, t_slice = xt, t_loc
    else:
        if t_loc % tp:
            raise ValueError(f"moe_a2a: {t_loc} local tokens do not split "
                             f"over {tp} ranks of {expert_axis!r}")
        t_slice = t_loc // tp
        xs = xt[mesh.axis_index(expert_axis) * t_slice:][:t_slice]
    gate, idx, probs = router_topk(xs @ router.to(xs.dtype), k,
                                   snl_rescue=snl_rescue, gumbel=gumbel)
    capacity = _capacity(t_slice, k, n_experts, capacity_factor)
    _record(stats, idx, capacity, n_experts)
    disp, comb = _dispatch_onehot(idx, gate, n_experts, capacity, xs.dtype)
    x_send = torch.einsum("tec,td->ecd", disp, xs)           # (E, C, D)
    x_recv = col.all_to_all(x_send, mesh, expert_axis, 0, 1)  # (E_loc, tp*C, D)
    y_loc = _expert_ffn(w_in, w_gate, w_out, x_recv, activation)
    y_send = col.all_to_all(y_loc, mesh, expert_axis, 1, 0)   # (E, C, D)
    ys = torch.einsum("ecd,tec->td", y_send, comb)            # (T_slice, D)
    if not seq_sharded:
        ys = col.all_gather(ys, mesh, expert_axis, 0)
    aux = aux_load_balance_loss(probs, idx, n_experts, k)
    aux = col.pmean(aux, mesh, expert_axis)
    for ax in taxes:
        aux = col.pmean(aux, mesh, ax)
    return (unshard(ys.reshape(bl, sl, dl), x_spec, mesh),
            unshard(aux, (), mesh))


def _wire_quantize(x: torch.Tensor):
    """Per-(expert, slot) int8 quantisation of a dispatch payload (the
    paper's NLQ idea applied to the wire): (q int8, scale f32 (..., 1))."""
    scale = torch.clamp(torch.amax(torch.abs(x), dim=-1, keepdim=True),
                        min=1e-8).float() / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127
                    ).to(torch.int8)
    return q, scale


def _wire_dequantize(q, scale, dtype):
    return (q.float() * scale).to(dtype)


# The post-exchange tokens of ``moe_2d`` under ``remat_policy``
# "save_moe_recv" (the reference's ``checkpoint_name(x_full,
# "moe_xfull")`` under ``save_only_these_names``): while a checkpointed
# forward runs, ``_pins`` is ("keep", kept) and each exchange appends its
# result to ``kept``; while its recompute runs, ("replay", kept) and each
# exchange takes the next kept result instead of issuing its collectives.
_pins: tuple[str, list] | None = None


@contextlib.contextmanager
def _pinning(mode: str, kept: list):
    global _pins
    outer, _pins = _pins, (mode, kept)
    try:
        yield
    finally:
        _pins = outer


def pinned_recv_contexts():
    """The two contexts of ``torch.utils.checkpoint``'s ``context_fn``
    for "save_moe_recv": the forward keeps ``moe_2d``'s post-exchange
    tokens, and the recompute takes them in the same order.  The kept
    tokens are the recompute's own bits, so nothing computed changes;
    the x-side ``all_to_all`` and all-gather leave the recompute (their
    transposes still run in the backward)."""
    kept: list = []
    return _pinning("keep", kept), _pinning("replay", kept)


class _Kept(torch.autograd.Function):
    """A kept post-exchange tensor in the recompute, with the backward
    of the exchange that made it: the all-gather's transpose
    (``psum_scatter`` over ``tp_axes``), then the ``all_to_all``'s
    (dims swapped)."""

    @staticmethod
    def forward(ctx, x_send, kept, mesh, eaxes, tp_axes):
        ctx.args = (mesh, eaxes, tp_axes)
        return kept.view_as(kept)

    @staticmethod
    def backward(ctx, g):
        mesh, eaxes, tp_axes = ctx.args
        if tp_axes:
            g = col._scatter(g, mesh, tp_axes, 1)
        if eaxes:
            g = col._exchange(g, mesh, eaxes, 1, 0)
        return g, None, None, None, None


def _exchanged(x_send: torch.Tensor, mesh, eaxes, tp_axis) -> torch.Tensor:
    """``moe_2d``'s x-side exchange: (E, C, D) sent over ``eaxes`` with
    ``all_to_all``, then gathered over ``tp_axis`` -> (E_loc, R*C*tp,
    D), kept or replayed under "save_moe_recv" (``_pins``)."""
    if _pins is not None and _pins[0] == "replay":
        kept = _pins[1].pop(0)
        if not x_send.is_floating_point():
            return kept
        return _Kept.apply(x_send, kept, mesh, mesh.axes(eaxes),
                           mesh.axes(tp_axis))
    x_full = col.all_gather(col.all_to_all(x_send, mesh, eaxes, 0, 1),
                            mesh, tp_axis, 1)
    if _pins is not None:
        _pins[1].append(x_full.detach())
    return x_full


def moe_2d(p: dict, x: torch.Tensor, *, k: int, mesh,
           activation: str = "silu", capacity_factor: float = 1.25,
           expert_axes=("pod", "data"), tp_axis: str = "model",
           wire_dtype: str = "bfloat16", snl_rescue: float = 0.0,
           gumbel: torch.Tensor | None = None, stats: dict | None = None,
           specs: dict | None = None):
    """2D expert + tensor parallelism: experts over ``expert_axes`` (the
    DP rows), each expert's FFN width over ``tp_axis``; ``p`` held in
    the layout ``specs``.

    Each rank routes its block of tokens (batch over the rows, sequence
    over ``tp_axis`` where it divides); the dispatch goes to the expert's
    row with ``all_to_all``, is gathered over ``tp_axis`` for the F-slice
    GEMMs, summed back with ``psum_scatter`` and returned with the
    reverse ``all_to_all``.  ``wire_dtype="int8"`` quantises both
    exchanges (and the gather) per (expert, slot); any other value sends
    the compute dtype as it is."""
    b, s, d = x.shape
    n_experts = p["router"].shape[-1]
    eaxes = tuple(a for a in expert_axes if a in mesh.shape)
    tp = mesh.shape[tp_axis]
    seq_ok = s % tp == 0
    row_spec = _spec(eaxes)
    x_spec = (row_spec, tp_axis if seq_ok else None, None)
    router = _held(p, specs, "router", (), mesh)
    w_in = _held(p, specs, "w_in", (row_spec, None, tp_axis), mesh)
    w_gate = _held(p, specs, "w_gate", (row_spec, None, tp_axis), mesh)
    w_out = _held(p, specs, "w_out", (row_spec, tp_axis, None), mesh)
    xl = shard(x, x_spec, mesh)

    bl, sl, dl = xl.shape
    xs = xl.reshape(bl * sl, dl)
    gate, idx, probs = router_topk(xs @ router.to(xs.dtype), k,
                                   snl_rescue=snl_rescue, gumbel=gumbel)
    capacity = _capacity(xs.shape[0], k, n_experts, capacity_factor)
    _record(stats, idx, capacity, n_experts)
    disp, comb = _dispatch_onehot(idx, gate, n_experts, capacity, xs.dtype)
    x_send = torch.einsum("tec,td->ecd", disp, xs)           # (E, C, D)
    if wire_dtype == "int8":
        # quantised once: int8 through the exchange and the TP gather
        xq, xscale = _wire_quantize(x_send)
        x_full = _wire_dequantize(_exchanged(xq, mesh, eaxes, tp_axis),
                                  _exchanged(xscale, mesh, eaxes, tp_axis),
                                  x_send.dtype)
    else:
        x_full = _exchanged(x_send, mesh, eaxes, tp_axis)  # (E_loc, R*C*tp, D)
    act = layers.ACTIVATIONS[activation]
    h = act(torch.matmul(x_full, w_in.to(x_full.dtype)))
    g = torch.matmul(x_full, w_gate.to(x_full.dtype))
    y_part = torch.matmul(h * g, w_out.to(x_full.dtype))
    y_loc = col.psum_scatter(y_part, mesh, tp_axis, 1)       # (E_loc, R*C, D)
    if wire_dtype == "int8":
        yq, yscale = _wire_quantize(y_loc)
        y_send = _wire_dequantize(col.all_to_all(yq, mesh, eaxes, 1, 0),
                                  col.all_to_all(yscale, mesh, eaxes, 1, 0),
                                  y_loc.dtype)
    else:
        y_send = col.all_to_all(y_loc, mesh, eaxes, 1, 0)    # (E, C, D)
    ys = torch.einsum("ecd,tec->td", y_send, comb)
    if not seq_ok:
        # the ranks of tp_axis routed the same tokens, but their
        # psum_scatter chunks were summed in other orders
        ys = col.replicate(ys, mesh, tp_axis)
    aux = aux_load_balance_loss(probs, idx, n_experts, k)
    aux = col.pmean(aux, mesh, eaxes + (tp_axis,))
    return (unshard(ys.reshape(bl, sl, dl), x_spec, mesh),
            unshard(aux, (), mesh))


def _local_dense(p_loc: dict, xt: torch.Tensor, comb: torch.Tensor,
                 activation: str) -> torch.Tensor:
    """Every local expert on every token of xt (T, D), combined with the
    local combine weights (T, E_loc): ``moe_ref``'s chunked sum."""
    n_loc = p_loc["w_in"].shape[0]
    y = None
    for e0, e1 in expert_chunks(n_loc, xt.shape[0],
                                max(xt.shape[-1], p_loc["w_in"].shape[-1])):
        part = combine_chunk(comb[:, e0:e1],
                             run_experts(p_loc, xt[None], e0, e1,
                                         activation))
        y = part if y is None else y + part
    return y.to(xt.dtype)


def moe_dense_ep_2d(p: dict, x: torch.Tensor, *, k: int, mesh,
                    activation: str = "silu", expert_axes=("pod", "data"),
                    tp_axis: str = "model", snl_rescue: float = 0.0,
                    gumbel: torch.Tensor | None = None,
                    specs: dict | None = None):
    """The decode shape of 2D-sharded experts: the (small) token batch
    gathered over the expert rows, every local expert's F-slice on every
    token, ``psum`` over the TP axis and the rows, then each row's tokens
    cut back out.  ``p`` is held in the layout ``specs``."""
    n_experts = p["router"].shape[-1]
    eaxes = tuple(a for a in expert_axes if a in mesh.shape)
    n_rows = math.prod(mesh.shape[a] for a in eaxes)
    e_loc = n_experts // n_rows
    row_spec = _spec(eaxes)
    x_spec = (row_spec, None, None)
    router = _held(p, specs, "router", (), mesh)
    p_loc = {"w_in": _held(p, specs, "w_in", (row_spec, None, tp_axis),
                           mesh),
             "w_gate": _held(p, specs, "w_gate", (row_spec, None, tp_axis),
                             mesh),
             "w_out": _held(p, specs, "w_out", (row_spec, tp_axis, None),
                            mesh)}
    xl = shard(x, x_spec, mesh)

    bl, sl, dl = xl.shape
    xt = xl.reshape(-1, dl)
    x_all = col.all_gather(xt, mesh, eaxes, 0)                # (T, D)
    gate, idx, probs = router_topk(x_all @ router.to(x_all.dtype), k,
                                   snl_rescue=snl_rescue, gumbel=gumbel)
    row = mesh.axis_index(eaxes)
    comb = combine_weights(gate, idx, n_experts, xt.dtype)   # (T, E)
    y_tok = _local_dense(p_loc, x_all, comb[:, row * e_loc:][:, :e_loc],
                         activation)
    y_tok = col.psum(y_tok, mesh, (tp_axis,) + eaxes)
    t_loc = xt.shape[0]
    y_mine = y_tok[row * t_loc:][:t_loc]
    aux = aux_load_balance_loss(probs, idx, n_experts, k)
    aux = col.pmean(aux, mesh, eaxes + (tp_axis,))
    return (unshard(y_mine.reshape(bl, sl, dl), x_spec, mesh),
            unshard(aux, (), mesh))


def moe_dense_ep(p: dict, x: torch.Tensor, *, k: int, mesh,
                 activation: str = "silu", token_axes=("pod", "data"),
                 expert_axis: str = "model", snl_rescue: float = 0.0,
                 gumbel: torch.Tensor | None = None,
                 specs: dict | None = None):
    """The decode shape of expert parallelism: every local expert on every
    local token, combined with the routing and summed (``psum``) over
    the expert axis.  ``p`` is held in the layout ``specs``."""
    n_experts = p["router"].shape[-1]
    e_loc = n_experts // mesh.shape[expert_axis]
    taxes = tuple(a for a in token_axes if a in mesh.shape)
    x_spec = (_spec(taxes), None, None)
    router = _held(p, specs, "router", (), mesh)
    p_loc = {n: _held(p, specs, n, (expert_axis,), mesh)
             for n in ("w_in", "w_gate", "w_out")}
    xl = shard(x, x_spec, mesh)

    bl, sl, dl = xl.shape
    xt = xl.reshape(-1, dl)                                   # (T_loc, D)
    gate, idx, probs = router_topk(xt @ router.to(xt.dtype), k,
                                   snl_rescue=snl_rescue, gumbel=gumbel)
    my = mesh.axis_index(expert_axis)
    comb = combine_weights(gate, idx, n_experts, xt.dtype)   # (T, E)
    y = _local_dense(p_loc, xt, comb[:, my * e_loc:][:, :e_loc], activation)
    y = col.psum(y, mesh, expert_axis)
    aux = aux_load_balance_loss(probs, idx, n_experts, k)
    for ax in taxes:
        aux = col.pmean(aux, mesh, ax)
    return (unshard(y.reshape(bl, sl, dl), x_spec, mesh),
            unshard(aux, (), mesh))
