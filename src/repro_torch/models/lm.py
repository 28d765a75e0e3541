"""The LM family: a repeating block pattern over layer groups, prefill,
and cache-based decode, for dense, MoE (kimi-k2, arctic), local/global
attention (gemma2), xLSTM and RG-LRU hybrid (recurrentgemma), the VLM
backbone (internvl2) and the encoder-only audio model (hubert)
configurations.

Counterpart of ``repro.models.lm``: the parameters are the reference's
nested dict (stacked ``layers/b{j}`` tensors with the group dimension
first, then ``tail{j}`` blocks), and its ``lax.scan`` over groups is a
Python loop here.  Paper integration points carried along: CIM-mode
projections (``cim_linear``: ternary twin-cell weights and NLQ
activations, paper C1/C2), KWN-FFN activation sparsity (``kwn_ffn_k``,
Eq. 1 with the FFN units as the neuron bank), the MoE router as a KWN
selection (``nn.moe``, paper C3) and the int8 / int4 KV cache
(``kv_quant``, the NLQ idea applied to serving).

Full-sequence attention goes through ``nn.attention.mha``: the flash
kernel where the reference's function is the Pallas kernel's, the plain
blockwise attention elsewhere.  The recurrent cells are ``nn.recurrent``;
an MoE block's FFN is ``nn.moe.moe_ref``, the function the reference
computes on one device, or with a ``mesh`` (``launch.mesh``) one of the
reference's expert-parallel paths (``_moe_apply``).

Under a mesh each rank computes its share of the partitioned step, as
the reference's sharding rules lay it out (``nn.module.DEFAULT_RULES``
under the config's ``sharding_overrides``): it holds its blocks of the
parameters (``nn.module.param_layout``), takes its block of the batch
(``batch_axes`` under the overrides: the rows over the "batch" axes,
and the sequence over "model" where the overrides put it there) and
its block of the decode cache (``cache_axes``: rows likewise, slots
over "model"), and splits the heads, FFN units and vocabulary over
"model" (Megatron's column- and row-parallel products with a sum over
"model" after each row-parallel one; ``nn.attention`` gathers a
projection whose block cuts a head, and ``nn.layers``' vocabulary-
parallel embedding and the cross entropy's max, sum and target combine
over "model").  Where the overrides put ``seq`` over "model" (qwen2.5,
nemotron, kimi-k2, arctic, internvl2) and the sequence divides over it,
the residual stream between the blocks is each rank's block (B, S / tp,
D) of the sequence (Megatron sequence parallelism, the layout of the
reference's ``_constrain_acts``): the norms, the residual adds and the
MoE router run on it, each tensor-parallel layer gathers the sequence
at its entry and reduce-scatters it at its exit (``nn.layers``'
``seq``), and the head gathers it before the vocabulary; such a call
takes the global length of its inputs' sequence in its plan
(``nn.module.plan(..., seq_len=)``).  Each block gathers its FSDP
leaves over the other axes inside the block (``_take``), and the
gradient goes back reduce-scattered onto the blocks, summed over the
ranks of the batch (and over "model" for the norms' scales, which see
the rank's block of the sequence).  The recurrent cells split over
"model" as the reference lays them out (``nn.recurrent``): RG-LRU's
``d_rnn`` channels, their state in the cache the rank's block of them;
the xLSTM cells' heads where they divide over "model" (elsewhere, as
xlstm's 4 heads over 16, the cell runs whole on every rank), their
states whole in the cache.  The MoE blocks take their expert
blocks as held and the rank's tokens as they arrive.  The modality
frontends are the reference's stubs: precomputed audio frames or ViT
patch embeddings through a learned projector.  An encoder-only model
has no decode step, here as in the reference.

Training (``features``, ``loss_fn``) runs under autograd: attention
takes the plain ``blockwise_attention`` there (the flash kernel has no
backward), and ``remat`` recomputes each layer group (``remat_mode``
"group") or each attention call ("attn_only"), and always the head with
its cross-entropy, in the backward (``torch.utils.checkpoint``, where
the reference has ``jax.checkpoint``).  A layer group's ``remat_policy``
chooses what its recompute keeps (``_remat``): "nothing" keeps nothing,
"dots" the outputs of the products with no batch dimension, and
"save_moe_recv" the post-exchange tokens of ``nn.moe.moe_2d``.  A policy
moves memory, FLOPs and wire bytes, never a value or a gradient.
``forward`` and ``decode_step`` are serving's and run under
``torch.no_grad()``.

``SHAPES``, ``batch_specs`` and ``batch_axes`` are the reference's input
cells for the dry run (``launch.dryrun``) and the roofline model
(``roofline.flops_model``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch import device as device_lib
from repro_torch.dist import collectives
from repro_torch.nn import attention, kvq, layers, moe, recurrent
from repro_torch.nn import module
from repro_torch.nn.module import ParamSpec, count_params, tree_map


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str                     # moe|dense|audio|ssm|hybrid|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    activation: str = "silu"
    gated_ffn: bool = True
    qkv_bias: bool = False
    attn_softcap: float | None = None
    final_softcap: float | None = None
    rope_theta: float = 10000.0
    pattern: tuple[str, ...] = ("attn",)   # attn | attn_local | mlstm | slstm | rglru
    window: int | None = None
    moe: bool = False
    n_experts: int = 0
    moe_top_k: int = 0
    moe_dense_residual: bool = False       # arctic: parallel dense FFN
    n_shared_experts: int = 0              # kimi: always-on experts
    encoder_only: bool = False
    frontend: str | None = None            # audio_frames | vision_patches
    frontend_dim: int = 0
    n_patches: int = 0
    tie_embeddings: bool = False
    scale_embed: bool = False
    post_norms: bool = False
    d_rnn: int = 0
    dtype: str = "bfloat16"
    remat: bool = True
    remat_mode: str = "group"        # group | attn_only
    remat_policy: str = "nothing"    # nothing | dots | save_moe_recv
    attn_chunk: int = 1024
    kv_quant: str | None = None      # None | int8 | int4
    moe_wire_dtype: str = "bfloat16"  # bfloat16 | int8
    moe_capacity_factor: float = 1.25
    cim_linear: bool = False
    kwn_ffn_k: int = 0
    sharding_overrides: dict | None = None
    supports_long_context: bool = False
    vocab_pad_to: int = 256

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        v, m = self.vocab_size, self.vocab_pad_to
        return ((v + m - 1) // m) * m

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail_pattern(self) -> tuple[str, ...]:
        r = self.n_layers % len(self.pattern)
        return self.pattern[:r]

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def param_count(self) -> int:
        return count_params(param_specs(self))

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only the top-k experts count).

        The reference's reckoning, kept as it is: every layer counts as an
        MoE layer, and ``dense_frac`` counts the shared experts among the
        routed ones although their weights sit outside the expert tree."""
        total = self.param_count()
        if not self.moe:
            return total
        expert = moe.moe_specs(self.d_model, self.d_ff, self.n_experts)
        expert_total = count_params({k: v for k, v in expert.items()
                                     if k != "router"})
        dense_frac = (self.moe_top_k + self.n_shared_experts) / self.n_experts
        return int(total - expert_total * self.n_layers * (1 - dense_frac))


# ===========================================================================
# Param specs
# ===========================================================================

def _ffn_specs(cfg: LMConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    s = {"w_in": layers.linear_spec(d, f, "embed", "ffn")}
    if cfg.gated_ffn:
        s["w_gate"] = layers.linear_spec(d, f, "embed", "ffn")
    s["w_out"] = layers.linear_spec(f, d, "ffn", "embed")
    return s


def _block_specs(cfg: LMConfig, kind: str) -> dict:
    d = cfg.d_model
    s: dict[str, Any] = {"norm1": layers.norm_spec(d)}
    if kind in ("attn", "attn_local"):
        s["attn"] = attention.attention_specs(d, cfg.n_heads, cfg.n_kv,
                                              cfg.hd, cfg.qkv_bias)
    elif kind == "mlstm":
        s["cell"] = recurrent.mlstm_specs(d, cfg.n_heads)
    elif kind == "slstm":
        s["cell"] = recurrent.slstm_specs(d, cfg.n_heads)
    elif kind == "rglru":
        s["cell"] = recurrent.rglru_specs(d, cfg.d_rnn or d)
    else:
        raise ValueError(kind)
    if cfg.post_norms:
        s["norm1_post"] = layers.norm_spec(d)
    if cfg.d_ff > 0 and kind not in ("mlstm", "slstm"):
        s["norm2"] = layers.norm_spec(d)
        if cfg.moe:
            s["moe"] = moe.moe_specs(d, cfg.d_ff, cfg.n_experts)
            if cfg.moe_dense_residual:
                s["ffn"] = _ffn_specs(cfg)
            if cfg.n_shared_experts:
                s["shared"] = _ffn_specs(dataclasses.replace(
                    cfg, d_ff=cfg.d_ff * cfg.n_shared_experts))
        else:
            s["ffn"] = _ffn_specs(cfg)
        if cfg.post_norms:
            s["norm2_post"] = layers.norm_spec(d)
    return s


def _stack_specs(specs: dict, n: int) -> dict:
    """Prepend a layer-group dim to every leaf spec."""
    return tree_map(lambda s: ParamSpec((n,) + s.shape, (None,) + s.axes,
                                        s.dtype, s.init, s.scale), specs)


def param_specs(cfg: LMConfig) -> dict:
    d = cfg.d_model
    p: dict[str, Any] = {}
    if cfg.frontend == "audio_frames":
        p["frontend_proj"] = layers.linear_spec(cfg.frontend_dim, d,
                                                "embed", None)
    if cfg.frontend == "vision_patches":
        p["patch_proj"] = layers.linear_spec(cfg.frontend_dim, d, None,
                                             "embed")
    if cfg.frontend != "audio_frames":
        p["embed"] = layers.embed_spec(cfg.padded_vocab, d)
    p["layers"] = {f"b{j}": _stack_specs(_block_specs(cfg, kind),
                                         cfg.n_groups)
                   for j, kind in enumerate(cfg.pattern)}
    for j, kind in enumerate(cfg.tail_pattern):
        p[f"tail{j}"] = _block_specs(cfg, kind)
    p["final_norm"] = layers.norm_spec(d)
    if cfg.encoder_only:
        p["head"] = layers.linear_spec(d, cfg.vocab_size, "embed", "classes")
    elif not cfg.tie_embeddings:
        p["head"] = layers.linear_spec(d, cfg.padded_vocab, "embed", "vocab")
    return p


# ===========================================================================
# Forward (full sequence / prefill)
# ===========================================================================

def _ffn_apply(p: dict, x: torch.Tensor, cfg: LMConfig, plan=None,
               width: int | None = None, seq: bool = False) -> torch.Tensor:
    """The (gated) FFN of ``width`` units (``cfg.d_ff``).  With a
    ``plan`` whose tensor-parallel axis cuts the units, ``p`` holds this
    rank's block of them: w_in / w_gate column-parallel, w_out
    row-parallel with its sum over the axis; KWN-FFN's threshold is
    taken over the units gathered from every rank.  CIM mode takes its
    leaves whole (``_take``) and sizes its NLQ codebook over every row of
    the batch.  With ``seq`` x is this rank's block of the sequence, and
    so is the result: the sequence gathered at the column-parallel entry
    and reduce-scattered at the row-parallel exit, or, for units whole on
    every rank, gathered and cut again."""
    if cfg.cim_linear:
        lin = layers.cim_linear if plan is None else functools.partial(
            layers.cim_linear, mesh=plan.mesh, axes=plan.dp_live)
    else:
        lin = layers.linear
    act = layers.ACTIVATIONS[cfg.activation]
    cut = plan is not None and plan.tp is not None and \
        p["w_in"]["w"].shape[1] != (width or cfg.d_ff)
    if cut:
        xin = collectives.gather_seq(x, plan.mesh, plan.tp) if seq else \
            collectives.copy_to(x, plan.mesh, plan.tp)
    else:
        xin = collectives.gather_from(x, plan.mesh, plan.tp, 1) if seq \
            else x
    h = act(lin(p["w_in"], xin))
    if cfg.gated_ffn:
        h = h * lin(p["w_gate"], xin)
    if cfg.kwn_ffn_k > 0:
        # Eq. (1) on FFN units: keep the top-k magnitudes per token (ties
        # at the k-th kept too), zero the rest.
        mag = torch.abs(h)
        every = collectives.gather_from(mag.detach(), plan.mesh, plan.tp,
                                        -1) if cut else mag
        thresh = torch.topk(every, cfg.kwn_ffn_k, dim=-1).values[..., -1:]
        h = torch.where(mag >= thresh, h, torch.zeros_like(h))
    if cut:
        return layers.row_linear(p["w_out"], h, plan.mesh, plan.tp, seq)
    y = lin(p["w_out"], h)
    return collectives.split_to(y, plan.mesh, plan.tp, 1) if seq else y


def _moe_apply(p: dict, x: torch.Tensor, cfg: LMConfig, plan=None,
               decode: bool = False, seq: bool = False):
    """The MoE FFN: the experts, then arctic's dense residual FFN, then
    kimi's shared experts, added in that order.  Returns (y, aux, or None
    in a decode step, whose aux the reference discards).

    The experts' path is the reference's choice: ``moe_ref`` with no
    mesh; with one, ``moe_2d`` (``moe_dense_ep_2d`` to decode) where the
    config's ``sharding_overrides`` lay the experts over the DP rows, else
    ``moe_a2a`` (sequence-sharded where the overrides shard ``seq`` over
    "model") or ``moe_dense_ep`` to decode.  Under a ``plan`` ``x`` is
    this rank's rows, split over the batch's axes, which must be the
    path's token axes (the "batch" rule's, ``nn.module.shard`` raises
    where they differ: a batch that does not divide over them).  With
    ``seq`` x is this rank's block of the sequence too: ``moe_2d`` takes
    it so (``split_seq``: its edges neither cut nor gather it), the other
    paths gather it and their output is cut again."""
    overrides = cfg.sharding_overrides or {}
    experts_rule = overrides.get("experts", "model")
    is_2d = experts_rule not in (None, "model")   # experts over DP rows
    kw = dict(k=cfg.moe_top_k, activation=cfg.activation)
    if plan is None:
        y, aux = moe.moe_ref(p["moe"], x, with_aux=not decode, **kw)
    else:
        mesh = plan.mesh
        kw["specs"] = module.param_layout(
            moe.moe_specs(cfg.d_model, cfg.d_ff, cfg.n_experts), mesh,
            overrides)
        xin, cut = x, False
        if is_2d:
            rows = tuple(experts_rule)
            fn = functools.partial(
                moe.moe_dense_ep_2d, expert_axes=rows) if decode else \
                functools.partial(moe.moe_2d, expert_axes=rows,
                                  capacity_factor=cfg.moe_capacity_factor,
                                  wire_dtype=cfg.moe_wire_dtype,
                                  split_seq=(plan.tp,) if seq else ())
        else:
            fn = moe.moe_dense_ep if decode else functools.partial(
                moe.moe_a2a, seq_sharded=overrides.get("seq") == "model")
            if seq:
                xin, cut = collectives.gather_from(x, mesh, plan.tp, 1), True
        y, aux = fn(p["moe"], xin, mesh=mesh, split=plan.dp, **kw)
        if cut:
            y = collectives.split_to(y, mesh, plan.tp, 1)
    if decode:
        aux = None
    if cfg.moe_dense_residual:
        y = y + _ffn_apply(p["ffn"], x, cfg, plan, seq=seq)
    if cfg.n_shared_experts:
        y = y + _ffn_apply(p["shared"], x, cfg, plan,
                           cfg.d_ff * cfg.n_shared_experts, seq)
    return y, aux


def _ffn_residual(p: dict, x: torch.Tensor, cfg: LMConfig, plan=None,
                  decode: bool = False, seq: bool = False):
    """The block's FFN half: (x + FFN(norm2(x)), aux loss f32, or None
    without MoE or in a decode step); ``seq`` as in ``_block_apply``."""
    aux = None
    if "norm2" not in p:
        return x, aux
    h = layers.rmsnorm(p["norm2"], x)
    if cfg.moe:
        h, aux = _moe_apply(p, h, cfg, plan, decode, seq)
    else:
        h = _ffn_apply(p["ffn"], h, cfg, plan, seq=seq)
    if cfg.post_norms:
        h = layers.rmsnorm(p["norm2_post"], h)
    return x + h, aux


# The leaves applied to the residual stream itself: under sequence
# parallelism to this rank's block of the sequence.
_ON_STREAM = frozenset({"norm1", "norm2", "norm1_post", "norm2_post",
                        "final_norm"})


def _take(p: dict, lay, cfg: LMConfig, plan, seq: bool = False,
          cut: bool = False) -> dict:
    """A block's dense leaves for this rank's compute from the blocks it
    holds (``nn.module.take_params``: gathered over the FSDP axes, inside
    the block, so a remat recompute gathers them again): a recurrent
    cell that runs on the rank's share (``cut``, ``_cell_cut``) as held
    over "model", its whole leaves used on a block (``lam``, ``wi``,
    ``wf``, ``r``) with their gradients summed over "model"; a cell that
    does not, and CIM-mode FFNs, whole over "model" too (they run whole
    on each of its ranks); the ``moe`` subtree as held.  With ``seq``
    the norms' gradients are summed over "model" too (each rank applied
    them to its block of the sequence).  No ``plan``: ``p`` as it is."""
    if plan is None:
        return p
    out = {}
    for k, v in p.items():
        if k == "moe":
            out[k] = v
        elif k == "cell" and cut:
            out[k] = tree_map(lambda t, spec: module.take_param(
                t, spec, plan, sliced=not _over(spec, plan.tp)), v, lay[k])
        else:
            out[k] = module.take_params(
                v, lay[k], plan,
                whole=k == "cell" or (cfg.cim_linear
                                      and k in ("ffn", "shared")),
                sliced=seq and k in _ON_STREAM)
    return out


def _over(spec: tuple, axis: str) -> bool:
    """Whether a leaf laid out by ``spec`` is cut over ``axis``."""
    return any(part == axis or (isinstance(part, tuple) and axis in part)
               for part in spec)


# The leaf of each recurrent cell whose layout says whether "model" cuts
# the cell: RG-LRU's channels, the xLSTM cells' heads.
_CELL_PROBE = {"rglru": "w_in", "mlstm": "wq", "slstm": "wx"}


def _cell_cut(kind: str, cfg: LMConfig, plan, lay) -> bool:
    """Whether a recurrent block's cell runs on this rank's share over
    "model", as the reference lays it out: RG-LRU on its block of the
    channels where the layout cuts ``d_rnn``, an xLSTM cell on its block
    of the heads where the layout cuts the projections and the heads
    divide over the axis (the condition of ``attention.heads_local``).
    Elsewhere the cell runs whole on every rank."""
    if plan is None or plan.tp is None or kind not in _CELL_PROBE:
        return False
    if not _over(lay["cell"][_CELL_PROBE[kind]]["w"], plan.tp):
        return False
    return kind == "rglru" or cfg.n_heads % plan.tp_size == 0


def _block_apply(kind: str, p: dict, x: torch.Tensor,
                 positions: torch.Tensor, cfg: LMConfig,
                 prefill: bool = False, plan=None, lay=None,
                 seq: bool = False):
    """One block.  Returns (x, aux loss or None, cache entry or None): K/V
    (ring-ordered with ``slot_pos`` for a local layer over a prompt longer
    than its window, quantized for a global one under ``kv_quant``) or the
    recurrent state.  Attention is causal unless the model is
    encoder-only.  Under a ``plan`` ``p`` is this rank's blocks laid out
    by ``lay`` (``_take``), ``x`` its rows, and the cache entry its block
    under ``cache_axes``.  With ``seq`` (sequence parallelism) ``x`` is
    this rank's block of the rows' sequence and so is the result;
    ``positions`` are the whole sequence's, and the cache entry is made
    from the whole sequence.  A recurrent cell runs on the rank's share
    where the layout cuts it (``_cell_cut``); its state comes out in the
    cache's layout (RG-LRU's the rank's block of its channels where they
    are cut, the xLSTM states whole)."""
    cut = _cell_cut(kind, cfg, plan, lay)
    p = _take(p, lay, cfg, plan, seq, cut)
    h = layers.rmsnorm(p["norm1"], x)
    cache = None
    if kind in ("attn", "attn_local"):
        window = cfg.window if kind == "attn_local" else None
        attn = functools.partial(
            attention.mha, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
            head_dim=cfg.hd, causal=not cfg.encoder_only, window=window,
            attn_softcap=cfg.attn_softcap, rope_theta=cfg.rope_theta,
            chunk=cfg.attn_chunk, return_kv=prefill, plan=plan, seq=seq)
        if cfg.remat and cfg.remat_mode == "attn_only":
            attn = _remat(attn)
        h = attn(p["attn"], h, positions)
        if prefill:
            h, (k, v) = h
            cache = attention.prefill_cache_from_kv(k, v, window)
            if cfg.kv_quant and "slot_pos" not in cache:
                kq, ks = kvq.quantize(cache["k"], cfg.kv_quant)
                vq, vs = kvq.quantize(cache["v"], cfg.kv_quant)
                cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
            if plan is not None:
                cache = _cache_block(cache, _entry_axes(kind, cfg), plan)
    else:
        # the cells run over the whole sequence
        if seq:
            h = collectives.gather_from(h, plan.mesh, plan.tp, 1)
        if kind == "mlstm":
            h = recurrent.mlstm_forward(p["cell"], h, cfg.n_heads,
                                        return_state=prefill, plan=plan)
        elif kind == "slstm":
            h = recurrent.slstm_forward(p["cell"], h, cfg.n_heads,
                                        return_state=prefill, plan=plan)
        elif kind == "rglru":
            h = recurrent.rglru_forward(p["cell"], h, return_state=prefill,
                                        plan=plan)
        if prefill:
            h, st = h
            cache = st._asdict()
        if seq:
            h = collectives.split_to(h, plan.mesh, plan.tp, 1)
    if cfg.post_norms:
        h = layers.rmsnorm(p["norm1_post"], h)
    x, aux = _ffn_residual(p, x + h, cfg, plan, seq=seq)
    return x, aux, cache


# The products with no batch dimension: ``x @ w`` of a (..., D) activation
# and a (D, F) weight reaches the dispatcher as ``mm`` on the flattened
# rows (the projections, the router, the head); the einsums of attention
# and of the experts reach it as ``bmm``.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep every ``mm``'s output,
    recompute the rest."""
    if op in _DOTS:
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _save_dots():
    return torch_checkpoint.create_selective_checkpoint_contexts(
        _dots_policy)


_POLICY_CONTEXTS = {"dots": _save_dots,
                    "save_moe_recv": moe.pinned_recv_contexts}


def _remat(fn, policy: str = "nothing"):
    """``fn`` recomputed in the backward instead of keeping what it
    saves (the reference's ``jax.checkpoint``), under ``policy``:

    * "nothing" keeps nothing (``nothing_saveable``);
    * "dots" keeps the outputs of the products with no batch dimension
      (``dots_with_no_batch_dims_saveable``), through
      ``torch.utils.checkpoint.create_selective_checkpoint_contexts``:
      the recompute replays them and recomputes the rest, the
      collectives included;
    * "save_moe_recv" keeps only ``nn.moe.moe_2d``'s post-exchange
      tokens (``save_only_these_names("moe_xfull")``): the recompute
      takes them as kept and issues neither the x-side ``all_to_all``
      nor the all-gather (``nn.moe.pinned_recv_contexts``; a selective
      policy could replay the tokens but would still run the exchange
      that makes them).

    Kept values are the bits the recompute would make, so no value or
    gradient depends on the policy.  Called as it is where autograd
    records nothing."""
    contexts = _POLICY_CONTEXTS.get(policy)
    if policy != "nothing" and contexts is None:
        raise ValueError(f"unknown remat_policy {policy!r}")

    @functools.wraps(fn)
    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        kw = {} if contexts is None else {"context_fn": contexts}
        return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                           **kw)
    return run


def _seq_lens(batch: dict, cfg: LMConfig, plan) -> tuple[int, int]:
    """(the global length of the inputs' sequence: the tokens, or the
    audio frames; that of the residual stream: the VLM's patches, then
    its tokens).  A rank's block of the inputs does not say whether
    sequence parallelism cut it: a plan that may cut it (``sp``) carries
    the global length (``nn.module.plan(..., seq_len=)``), and a block of
    another length than the one it gives raises ``ValueError``."""
    key = "frames" if cfg.frontend == "audio_frames" else "tokens"
    n = local = batch[key].shape[1]
    if plan is not None and plan.sp:
        if plan.seq_len is None:
            raise ValueError(
                f"{cfg.name} under a mesh that cuts the sequence over "
                f"{plan.tp!r} (its overrides' \"seq\"): the call needs the "
                "global length of its inputs' sequence, "
                "nn.module.plan(mesh, rules, batch=, seq_len=)")
        n = plan.seq_len
        want = n // plan.tp_size if plan.cuts_seq(n) else n
        if local != want:
            raise ValueError(f"{key} of {local} positions a rank: this "
                             f"rank's block of {n} has {want}")
    prefix = cfg.n_patches if cfg.frontend == "vision_patches" else 0
    return n, n + prefix


def _sp(plan, n: int) -> bool:
    """Whether sequence parallelism cuts a sequence of ``n`` positions
    under ``plan``."""
    return plan is not None and plan.cuts_seq(n)


def _seq_whole(t: torch.Tensor, plan, cut: bool) -> torch.Tensor:
    """A (B, S, ...) input leaf whole over its sequence: gathered over
    "model" where sequence parallelism ``cut`` it (the tokens without a
    graph)."""
    return collectives.gather_seq(t, plan.mesh, plan.tp) if cut else t


def _embed_inputs(params: dict, batch: dict, cfg: LMConfig, plan=None,
                  lay=None, s_in: int = 0) -> torch.Tensor:
    """The model's input sequence (B, S, D): audio frames (B, S,
    frontend_dim) through ``frontend_proj``; else the token embeddings,
    after the ViT patches (B, n_patches, frontend_dim) through
    ``patch_proj`` for the VLM.  Under a ``plan`` the rank's rows, the
    table vocabulary-parallel where "model" cuts it.  Where sequence
    parallelism cuts the inputs' ``s_in`` positions, the rank's block of
    them is gathered first; a text model's vocabulary-parallel lookup
    then ends in a reduce-scatter along the sequence, so the result is
    this rank's block of it, and is whole over it elsewhere (cut by
    ``_constrain_acts``)."""
    p = _take({k: params[k] for k in ("frontend_proj", "patch_proj",
                                      "embed") if k in params},
              lay, cfg, plan)
    cut = _sp(plan, s_in)
    if cfg.frontend == "audio_frames":
        frames = _seq_whole(batch["frames"], plan, cut)
        return layers.linear(p["frontend_proj"],
                             frames.to(cfg.compute_dtype))
    x = _embed(p["embed"], _seq_whole(batch["tokens"], plan, cut), cfg,
               plan, seq=cut and cfg.frontend is None)
    if cfg.frontend == "vision_patches":
        patches = layers.linear(p["patch_proj"],
                                batch["patches"].to(cfg.compute_dtype))
        x = torch.cat([patches, x], dim=1)
    return x


def _vocab_cut(table: torch.Tensor, cfg: LMConfig, plan) -> bool:
    return plan is not None and plan.tp is not None and \
        table.shape[0] != cfg.padded_vocab


def _embed(p: dict, tokens: torch.Tensor, cfg: LMConfig, plan,
           seq: bool = False):
    if _vocab_cut(p["table"], cfg, plan):
        x = layers.embed_vocab(p, tokens, plan.mesh, plan.tp,
                               scale_by_dim=cfg.scale_embed, seq=seq)
    else:
        x = layers.embed(p, tokens, scale_by_dim=cfg.scale_embed)
    return x.to(cfg.compute_dtype)


def _group(tree: dict, g: int) -> dict:
    """Group ``g``'s slice of a stacked tree (views, no copies)."""
    return tree_map(lambda t: t[g], tree)


def _head_logits(params: dict, x: torch.Tensor, cfg: LMConfig, plan=None,
                 seq: bool = False):
    """(f32 logits after the final softcap: the padded vocabulary, or an
    encoder-only model's ``vocab_size`` classes; the first column of this
    rank's block of them, or None where they are whole).  ``x`` has
    passed ``final_norm``; ``params`` hold the rank's blocks of the head
    or the tied table, gathered here (``_take``), the vocabulary
    column-parallel where "model" cuts it.  With ``seq`` x is this
    rank's block of the sequence, gathered here (Megatron's exit from
    sequence parallelism): the logits are over the whole sequence."""
    mesh = plan.mesh if plan is not None else None

    def enter(x, cut):
        if cut:
            return collectives.gather_seq(x, mesh, plan.tp) if seq else \
                collectives.copy_to(x, mesh, plan.tp)
        return collectives.gather_from(x, mesh, plan.tp, 1) if seq else x

    if cfg.tie_embeddings and not cfg.encoder_only:
        w = params["embed"]["table"]
        cut = _vocab_cut(w, cfg, plan)
        logits = layers.unembed(params["embed"], enter(x, cut))
    else:
        full = cfg.vocab_size if cfg.encoder_only else cfg.padded_vocab
        cut = plan is not None and plan.tp is not None and \
            params["head"]["w"].shape[1] != full
        logits = layers.linear(params["head"], enter(x, cut))
    first = layers.vocab_block(logits.shape[-1], mesh, plan.tp) if cut \
        else None
    return layers.softcap(logits.float(), cfg.final_softcap), first


def _logits(params: dict, x: torch.Tensor, cfg: LMConfig, plan=None,
            lay=None, seq: bool = False) -> torch.Tensor:
    """f32 logits: the vocabulary padded to ``padded_vocab``, or an
    encoder-only model's ``vocab_size`` classes; under a ``plan`` the
    rank's rows, gathered whole over the vocabulary (and, from its block
    of the sequence with ``seq``, over the sequence)."""
    head = _take({k: params[k] for k in ("final_norm", "head", "embed")
                  if k in params}, lay, cfg, plan, seq)
    x = layers.rmsnorm(head["final_norm"], x)
    logits, first = _head_logits(head, x, cfg, plan, seq)
    if first is not None:
        logits = collectives.gather_from(logits, plan.mesh, plan.tp, -1)
    return logits


def _add_aux(acc, aux):
    """``acc + aux`` where None stands for 0: the reference's sum from
    zeros (0 + a is a in f32), with no tensor made or added for blocks
    without MoE."""
    if aux is None:
        return acc
    return aux if acc is None else acc + aux


def _layout(cfg: LMConfig, plan):
    """The layout in which a rank holds the parameters under ``plan``
    (``nn.module.param_layout`` of ``param_specs`` under the config's
    overrides), or None without one."""
    if plan is None:
        return None
    return module.param_layout(param_specs(cfg), plan.mesh,
                               cfg.sharding_overrides)


def _grouped(lay):
    """A stacked subtree's layout without its group dim."""
    return tree_map(lambda spec: tuple(spec[1:]), lay)


def _plan(cfg: LMConfig, mesh):
    return module.plan(mesh, cfg.sharding_overrides)


def _constrain_acts(x: torch.Tensor, cfg: LMConfig, plan,
                    s: int) -> torch.Tensor:
    """The residual stream (B, S, D) of ``s`` positions in the layout of
    the reference's ``_constrain_acts`` (a sharding constraint to
    ("batch", "seq", None) under the config's rules): where its
    overrides put ``seq`` over "model" and ``s`` divides over it
    (``_sp``), each rank's block (B, S / tp, D) of the sequence (Megatron
    sequence parallelism), else its rows whole over the sequence and the
    same on every rank of "model".  A whole stream (the embedding's
    output where it does not end in a reduce-scatter) is cut
    (``split_to``, whose backward gathers the blocks' cotangents); the
    blocks leave it cut."""
    if not _sp(plan, s) or x.shape[1] != s:
        return x
    return collectives.split_to(x, plan.mesh, plan.tp, 1)


@torch.no_grad()
def forward(params: dict, batch: dict, cfg: LMConfig, mesh=None,
            prefill: bool = False):
    """Returns (logits, aux_loss[, cache]).

    ``prefill=True`` is the serving prefill: logits of the LAST position
    only (B, V), and the per-layer decode cache (each entry's tensors
    stacked over groups for the pattern blocks): roped K/V (B, S, n_kv,
    hd), quantized under ``kv_quant``, ring-ordered for local layers over
    a prompt longer than the window, recurrent states for xLSTM and
    RG-LRU blocks.  The full forward returns logits (B, S, V).  ``batch``
    holds ``tokens`` (B, S), with ``patches`` (B, n_patches,
    frontend_dim) before them for the VLM, or ``frames`` (B, S,
    frontend_dim) for the audio model.  Logits are f32; the aux loss (f32)
    is the MoE blocks' load-balancing loss, summed over each group's
    blocks, then over the groups, then over the tail, as the reference
    sums it (0 without MoE).

    With a ``mesh`` (``launch.mesh``, or an ``nn.module.Plan``) the call
    is this rank's share of the partitioned step, as the reference's
    sharding rules lay it out; every rank of the mesh must make it.
    ``params`` are this rank's blocks (``param_layout``), ``batch`` its
    block (``blocks_like`` of ``batch_axes`` under the config's
    overrides: the rows over the mesh's "batch" axes, and the sequence
    over "model" where the overrides put it there and it divides; such a
    call's plan carries the inputs' global length, ``nn.module.plan(...,
    seq_len=)``), and the results its own: the logits of its rows, whole
    over the sequence and the vocabulary; the aux loss, global and the
    same on every rank; the cache its block under ``cache_axes``.  The
    heads, FFN units and vocabulary split over "model" (Megatron's
    column- and row-parallel products), the residual stream is each
    rank's block of the sequence under sequence parallelism
    (``_constrain_acts``), FSDP's leaves are gathered block by block, and
    the MoE blocks take the reference's expert-parallel paths
    (``_moe_apply``).
    """
    plan = _plan(cfg, mesh)
    lay = _layout(cfg, plan)
    s_in, s = _seq_lens(batch, cfg, plan)
    sp = _sp(plan, s)
    x = _constrain_acts(_embed_inputs(params, batch, cfg, plan, lay, s_in),
                        cfg, plan, s)
    b = x.shape[0]
    positions = torch.arange(s, device=x.device).expand(b, s)
    caches: dict[str, list] = {f"b{j}": [] for j in range(len(cfg.pattern))}
    aux = None
    for g in range(cfg.n_groups):
        gp = _group(params["layers"], g)
        aux_g = None
        for j, kind in enumerate(cfg.pattern):
            x, aux_b, c = _block_apply(
                kind, gp[f"b{j}"], x, positions, cfg, prefill, plan,
                lay and _grouped(lay["layers"][f"b{j}"]), sp)
            x = _constrain_acts(x, cfg, plan, s)
            aux_g = _add_aux(aux_g, aux_b)
            if prefill:
                caches[f"b{j}"].append(c)
        aux = _add_aux(aux, aux_g)
    cache: dict[str, dict] = {}
    if prefill:
        cache = {name: {key: torch.stack([c[key] for c in entries])
                        for key in entries[0]}
                 for name, entries in caches.items()}
    for j, kind in enumerate(cfg.tail_pattern):
        x, aux_t, c = _block_apply(kind, params[f"tail{j}"], x, positions,
                                   cfg, prefill, plan,
                                   lay and lay[f"tail{j}"], sp)
        aux = _add_aux(aux, aux_t)
        if prefill:
            cache[f"tail{j}"] = c
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if prefill:
        last = x[:, -1:]
        if sp:
            # the last position of the gathered sequence: the last rank's
            last = collectives.gather_from(last, plan.mesh, plan.tp,
                                           1)[:, -1:]
        return _logits(params, last, cfg, plan, lay)[:, 0], aux, cache
    return _logits(params, x, cfg, plan, lay, sp), aux


# ===========================================================================
# Training: features, head + cross-entropy, loss
# ===========================================================================

def _groups(tree: dict, n: int) -> list[dict]:
    """The stacked tree's ``n`` group slices, each leaf unbound once: its
    backward stacks the groups' gradients into one tensor, where a slice
    a group would add a full-size zero-padded gradient for each."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda ts: ts[g], parts) for g in range(n)]


def features(params: dict, batch: dict, cfg: LMConfig, mesh=None):
    """The forward up to, not including, the unembedding: (x after
    ``final_norm`` (B, S, D), the aux loss f32, summed as ``forward``
    sums it).  Each layer group is recomputed in the backward under
    ``remat`` with ``remat_mode`` "group".  ``mesh`` as in ``forward``:
    x is this rank's rows (the same on every rank of "model", or under
    sequence parallelism its block (B, S / tp, D) of the sequence); the
    gradient of each block this rank holds is that block of the global
    function's gradient."""
    plan = _plan(cfg, mesh)
    return _features(params, batch, cfg, plan, _layout(cfg, plan))[:2]


def _features(params: dict, batch: dict, cfg: LMConfig, plan, lay):
    """``features`` under a plan and its layout, and whether sequence
    parallelism cut x."""
    s_in, s = _seq_lens(batch, cfg, plan)
    sp = _sp(plan, s)
    x = _constrain_acts(_embed_inputs(params, batch, cfg, plan, lay, s_in),
                        cfg, plan, s)
    b = x.shape[0]
    positions = torch.arange(s, device=x.device).expand(b, s)
    group_lay = {f"b{j}": lay and _grouped(lay["layers"][f"b{j}"])
                 for j in range(len(cfg.pattern))}

    def group_fn(x, gp):
        aux_g = None
        for j, kind in enumerate(cfg.pattern):
            x, aux_b, _ = _block_apply(kind, gp[f"b{j}"], x, positions, cfg,
                                       plan=plan, lay=group_lay[f"b{j}"],
                                       seq=sp)
            x = _constrain_acts(x, cfg, plan, s)
            aux_g = _add_aux(aux_g, aux_b)
        return x, aux_g

    if cfg.remat and cfg.remat_mode == "group":
        group_fn = _remat(group_fn, cfg.remat_policy)
    aux = None
    for gp in _groups(params["layers"], cfg.n_groups):
        x, aux_g = group_fn(x, gp)
        aux = _add_aux(aux, aux_g)
    for j, kind in enumerate(cfg.tail_pattern):
        x, aux_t, _ = _block_apply(kind, params[f"tail{j}"], x, positions,
                                   cfg, plan=plan, lay=lay and lay[f"tail{j}"],
                                   seq=sp)
        aux = _add_aux(aux, aux_t)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    norm = _take({"final_norm": params["final_norm"]}, lay, cfg, plan, sp)
    return layers.rmsnorm(norm["final_norm"], x), aux, sp


def _cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                   plan=None, first=None) -> torch.Tensor:
    """Per-position -log softmax(logits)[target], f32.  With ``first``
    the logits are this rank's block of the columns from ``first`` on
    (the vocabulary over ``plan.tp``): the max, the sum of the
    exponentials and the target's logit are combined over the axis."""
    if first is None:
        lse = torch.log_softmax(logits, dim=-1)
        return -torch.gather(lse, -1, targets.long()[..., None])[..., 0]
    mesh, ax = plan.mesh, plan.tp
    m = collectives.pmax(torch.amax(logits, dim=-1, keepdim=True), mesh, ax)
    se = collectives.reduce_from(
        torch.sum(torch.exp(logits - m), dim=-1), mesh, ax)
    at = targets.long() - first
    mine = (at >= 0) & (at < logits.shape[-1])
    z = torch.gather(logits, -1, torch.where(mine, at, 0)[..., None])[..., 0]
    z = collectives.reduce_from(z * mine, mesh, ax)
    return torch.log(se) + m[..., 0] - z


def _masked_mean(ce: torch.Tensor, mask: torch.Tensor | None,
                 plan=None) -> torch.Tensor:
    """The mean of ``ce`` over its positions, or over those ``mask``
    keeps.  Under a ``plan`` with a split batch the global mean: the
    sums and the counts summed over the batch's axes (each rank's
    gradient is that of its rows' part)."""
    dp = plan.dp_live if plan is not None else ()
    if mask is None:
        if not dp:
            return torch.mean(ce)
        n = torch.tensor(float(ce.numel()), device=ce.device)
        return collectives.reduce_from(torch.sum(ce), plan.mesh, dp) / \
            collectives.psum(n, plan.mesh, dp)
    m = mask.float()
    num, den = torch.sum(ce * m), torch.sum(m)
    if dp:
        num = collectives.reduce_from(num, plan.mesh, dp)
        den = collectives.psum(den.detach(), plan.mesh, dp)
    return num / torch.clamp(den, min=1.0)


def _head_and_ce(params: dict, x: torch.Tensor, batch: dict,
                 cfg: LMConfig, plan=None, lay=None,
                 seq: bool = False) -> torch.Tensor:
    """Unembedding and cross-entropy, f32.  A decoder predicts each next
    token over the padded vocabulary (the logits of the VLM's patch
    prefix dropped), averaged over the positions, or over those
    ``loss_mask`` keeps; an encoder-only model its ``targets`` over its
    classes where ``loss_mask`` is set.  Under a ``plan`` vocabulary-
    parallel where "model" cuts it, the mean global (``_masked_mean``);
    with ``seq`` x is this rank's block of the sequence, gathered before
    the head, and the batch's leaves cut along the sequence are gathered
    too, so each position is scored against the next token across the
    blocks' boundaries."""
    params = _take(params, lay, cfg, plan)
    logits, first = _head_logits(params, x, cfg, plan, seq)
    cut = _sp(plan, _seq_lens(batch, cfg, plan)[0])

    def whole(key):
        t = batch.get(key)
        return None if t is None else _seq_whole(t, plan, cut)

    if cfg.encoder_only:
        return _masked_mean(_cross_entropy(logits, whole("targets"), plan,
                                           first), whole("loss_mask"), plan)
    n_prefix = cfg.n_patches if cfg.frontend == "vision_patches" else 0
    tokens = whole("tokens")
    ce = _cross_entropy(logits[:, n_prefix:][:, :-1], tokens[:, 1:], plan,
                        first)
    mask = whole("loss_mask")
    return _masked_mean(ce, None if mask is None else mask[:, 1:], plan)


def loss_fn(params: dict, batch: dict, cfg: LMConfig, mesh=None):
    """(ce + 0.01 * aux, {"ce", "aux"}), differentiable in ``params``.
    The head and cross-entropy are recomputed in the backward as one
    unit, so the (B, S, V) logits and their softmax are never kept.
    ``mesh`` as in ``forward``: the loss is the global scalar on every
    rank, and each rank's gradient of it is its blocks of the global
    gradient."""
    plan = _plan(cfg, mesh)
    lay = _layout(cfg, plan)
    x, aux, sp = _features(params, batch, cfg, plan, lay)
    keys = [k for k in ("head", "embed") if k in params]
    head = {k: params[k] for k in keys}
    ce = _remat(_head_and_ce)(head, x, batch, cfg, plan,
                              lay and {k: lay[k] for k in keys}, sp)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


# ===========================================================================
# Decode (serve_step)
# ===========================================================================

def _zeros(shape, dtype, device, fill=0) -> torch.Tensor:
    """A constant (B, ...) cache leaf as a broadcast view of one element:
    ``cache_on`` copies what it keeps (a rank's block of it)."""
    return torch.full((), fill, dtype=dtype, device=device).expand(shape)


def _cache_spec_for(kind: str, cfg: LMConfig, batch: int, s_max: int,
                    device) -> dict:
    hd = cfg.hd
    if kind == "attn":
        if cfg.kv_quant:
            shape = (batch, s_max, cfg.n_kv,
                     kvq.storage_shape(hd, cfg.kv_quant))
            sd = kvq.storage_dtype(cfg.kv_quant)
            scale = (batch, s_max, cfg.n_kv, 1)
            return {"k": _zeros(shape, sd, device),
                    "v": _zeros(shape, sd, device),
                    "k_scale": _zeros(scale, torch.float32, device),
                    "v_scale": _zeros(scale, torch.float32, device)}
        shape = (batch, s_max, cfg.n_kv, hd)
        return {"k": _zeros(shape, cfg.compute_dtype, device),
                "v": _zeros(shape, cfg.compute_dtype, device)}
    if kind == "attn_local":
        w = min(cfg.window or s_max, s_max)
        shape = (batch, w, cfg.n_kv, hd)
        return {"k": _zeros(shape, cfg.compute_dtype, device),
                "v": _zeros(shape, cfg.compute_dtype, device),
                "slot_pos": _zeros((batch, w), torch.int32, device, -1)}
    hd_cell = cfg.d_model // cfg.n_heads
    if kind == "mlstm":
        st = recurrent.mlstm_init_state(batch, cfg.n_heads, hd_cell,
                                        device=device)
    elif kind == "slstm":
        st = recurrent.slstm_init_state(batch, cfg.n_heads, hd_cell, device)
    elif kind == "rglru":
        st = recurrent.rglru_init_state(batch, cfg.d_rnn or cfg.d_model,
                                        device=device)
    else:
        raise ValueError(kind)
    return st._asdict()


def init_cache(cfg: LMConfig, batch: int, s_max: int, device=None, *,
               mesh=None) -> dict:
    """A fresh decode cache on ``device`` (``cuda`` unless the caller
    passes ``device="cpu"``): for each pattern block its entry stacked
    over groups (G, B, ...), for each tail block (B, ...).  Global
    attention: K/V (B, s_max, n_kv, hd), or the int8 / int4 payload and
    f32 scales under ``kv_quant``; local attention: a ring of min(window,
    s_max) slots with ``slot_pos`` -1; recurrent blocks: their initial
    states.  With a ``mesh`` (``batch`` the global batch) this rank's
    block of it under ``cache_axes``."""
    return cache_on(cfg, batch, s_max, device_lib.resolve(device), mesh=mesh)


def cache_on(cfg: LMConfig, batch: int, s_max: int, device, *,
             mesh=None) -> dict:
    """``init_cache`` on ``device`` as given: also a fake CUDA device or
    ``meta``, where the dry run (``launch.dryrun``) lays out a cache that
    holds no data.  Under a ``mesh`` only this rank's block is made."""
    dev = torch.device(device)
    rules = None
    if mesh is not None:
        mesh = module.plan(mesh, cfg.sharding_overrides).mesh
        rules = cfg.sharding_overrides
    axes = cache_axes(cfg)

    def keep(t, ax):
        if mesh is not None:
            t = module.block_like(t, ax, mesh, rules)
        return t.clone(memory_format=torch.contiguous_format)

    cache = {}
    for j, kind in enumerate(cfg.pattern):
        one = _cache_spec_for(kind, cfg, batch, s_max, dev)
        cache[f"b{j}"] = {key: keep(t.expand(cfg.n_groups, *t.shape),
                                    axes[f"b{j}"][key])
                          for key, t in one.items()}
    for j, kind in enumerate(cfg.tail_pattern):
        one = _cache_spec_for(kind, cfg, batch, s_max, dev)
        cache[f"tail{j}"] = {key: keep(t, axes[f"tail{j}"][key])
                             for key, t in one.items()}
    return cache


def _entry_axes(kind: str, cfg: LMConfig) -> dict:
    """The logical axes of one group's cache entry (``cache_axes``
    without the group dim)."""
    return {k: a[1:] for k, a in _kind_axes(kind, cfg).items()}


def _kind_axes(kind: str, cfg: LMConfig) -> dict:
    if kind in ("attn", "attn_local"):
        kv = ("k", "v") + (("k_scale", "v_scale")
                           if kind == "attn" and cfg.kv_quant else ())
        out = {k: (None, "batch", "cache_seq", "cache_heads", None)
               for k in kv}
        if kind == "attn_local":
            out["slot_pos"] = (None, "batch", None)
        return out
    if kind == "mlstm":
        return {"c": (None, "batch", None, None, None),
                "n": (None, "batch", None, None),
                "m": (None, "batch", None)}
    if kind == "slstm":
        return {k: (None, "batch", None, None) for k in "cnhm"}
    if kind == "rglru":
        return {"h": (None, "batch", "ffn"),
                "conv": (None, "batch", None, "ffn")}
    raise ValueError(kind)


def cache_axes(cfg: LMConfig) -> dict:
    """The logical axes of every cache leaf (for its layout), the
    reference's: the batch, the slots (``cache_seq``, split-KV over
    "model"), the heads whole; RG-LRU's state over ``ffn``.  A pattern
    block's entry leads with its group dim, a tail block's has none."""
    ax = {f"b{j}": _kind_axes(kind, cfg) for j, kind in enumerate(cfg.pattern)}
    for j, kind in enumerate(cfg.tail_pattern):
        ax[f"tail{j}"] = _entry_axes(kind, cfg)
    return ax


# The layout of a rank's rows: the batch is cut already.
_ROWS = {"batch": None}


def _cache_block(entry: dict, axes: dict, plan) -> dict:
    """One group's cache entry of this rank's rows cut to its block
    under ``axes`` (the slots over "model" where they divide)."""
    return {k: module.block_like(t, axes[k], plan.mesh, _ROWS).contiguous()
            for k, t in entry.items()}


def pad_cache(cache: dict, cfg: LMConfig, s_max: int, *, mesh=None,
              seq: int | None = None) -> dict:
    """Grow a prefill-produced cache (seq = prompt length) to ``s_max``
    slots so decode can append: global-attention K/V (and scales) are
    zero-padded on the sequence dim (the third from the end); ring
    buffers and recurrent states are already final and stay as they
    are.  With a ``mesh`` the cache is this rank's block (``forward``'s
    prefill under it) of ``seq`` slots, and so is the result, of
    ``s_max``: the slots gathered over "model" where they were cut,
    padded, and cut again under ``cache_axes``."""
    plan = _plan(cfg, mesh)

    def pad(t: torch.Tensor) -> torch.Tensor:
        cur = t.shape[-3]
        if cur >= s_max:
            return t
        shape = list(t.shape)
        shape[-3] = s_max - cur
        return torch.cat([t, t.new_zeros(shape)], dim=-3)

    def relaid(t: torch.Tensor, ax: tuple) -> torch.Tensor:
        if plan is None or plan.tp is None:
            return pad(t)
        if seq is None:
            raise ValueError("pad_cache under a mesh needs the prompt "
                             "length (seq=)")
        d = t.ndim - 3
        if t.shape[d] != seq:
            t = collectives.gather_from(t, plan.mesh, plan.tp, d)
        return module.block_like(pad(t), ax, plan.mesh, _ROWS).contiguous()

    axes = cache_axes(cfg)

    def pad_entry(name: str, entry: dict) -> dict:
        if "slot_pos" in entry or "k" not in entry:
            return entry
        return {key: relaid(t, axes[name][key]) for key, t in entry.items()}

    return {name: pad_entry(name, entry) for name, entry in cache.items()}


def _ring_decode(p: dict, x: torch.Tensor, cache: dict, pos: torch.Tensor,
                 cfg: LMConfig, plan=None) -> torch.Tensor:
    """Sliding-window ring-buffer decode of a local attention layer: the
    new K/V go to slot pos % w, written into ``cache`` in place with their
    position in ``slot_pos``; a slot is seen while its position is within
    the window.  Under a ``plan`` the ring's K/V may be this rank's block
    of its slots (``slot_pos``, whole on every rank, gives their count):
    the rank writes the slots of its block, and the attention is split
    over the blocks (``attention._attend``)."""
    if "slot_pos" not in cache:
        raise ValueError(
            "a local-attention cache without slot_pos: prefill over a "
            "prompt no longer than the window returns plain K/V, which the "
            "ring decode cannot continue (the reference raises KeyError "
            "here); prefill a prompt longer than the window, or decode "
            "token by token from init_cache")
    b = x.shape[0]
    w = cache["slot_pos"].shape[1]
    w_loc = cache["k"].shape[1]
    first, split = attention.slot_block(w_loc, w, plan)
    q, k_new, v_new = attention._qkv_decode(p, x, pos, cfg.n_heads, cfg.n_kv,
                                            cfg.hd, cfg.rope_theta, True,
                                            plan)
    slot = pos % w
    attention._write_at_pos([cache["k"], cache["v"]], [k_new, v_new], slot,
                            w, first)
    attention.write_rows(cache["slot_pos"], slot, pos)
    slot_pos = cache["slot_pos"][:, first:first + w_loc]
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None]) & \
        (slot_pos > pos[:, None] - (cfg.window or w))
    o = attention._attend(q, cache["k"], cache["v"], valid, cfg.hd,
                          cfg.attn_softcap, cfg.n_heads // cfg.n_kv, split)
    return attention._wo(p["wo"], o, cfg.n_heads, cfg.hd, plan)


_STATES = {"mlstm": (recurrent.MLSTMState, recurrent.mlstm_decode_step),
           "slstm": (recurrent.SLSTMState, recurrent.slstm_decode_step),
           "rglru": (recurrent.RGLRUState, recurrent.rglru_decode_step)}


def _block_decode(kind: str, p: dict, x: torch.Tensor, cache: dict,
                  pos: torch.Tensor, cfg: LMConfig, plan=None,
                  lay=None) -> torch.Tensor:
    """One block's decode step; its cache entry is updated in place.
    Under a ``plan`` ``p`` is this rank's blocks laid out by ``lay``,
    ``x`` its rows and ``cache`` its block of the entry.  A recurrent
    cell steps its state as the cache holds it, the layout that cuts the
    cell's leaves cutting its state alike (RG-LRU's the rank's channels
    where they are cut; the xLSTM states whole, a cell cut by head
    writing the same whole state on every rank)."""
    cut = _cell_cut(kind, cfg, plan, lay)
    p = _take(p, lay, cfg, plan, cut=cut)
    h = layers.rmsnorm(p["norm1"], x)
    if kind == "attn" and cfg.kv_quant:
        h, _ = attention.mha_decode_quant(
            p["attn"], h, cache, pos, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
            head_dim=cfg.hd, kv_quant=cfg.kv_quant,
            attn_softcap=cfg.attn_softcap, rope_theta=cfg.rope_theta,
            plan=plan)
    elif kind == "attn":
        h, _ = attention.mha_decode(
            p["attn"], h, attention.KVCache(cache["k"], cache["v"]), pos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
            attn_softcap=cfg.attn_softcap, rope_theta=cfg.rope_theta,
            plan=plan)
    elif kind == "attn_local":
        h = _ring_decode(p["attn"], h, cache, pos, cfg, plan)
    else:
        state_cls, step = _STATES[kind]
        if kind == "rglru":
            h, st = step(p["cell"], h, state_cls(**cache), plan=plan)
        else:
            h, st = step(p["cell"], h, state_cls(**cache), cfg.n_heads,
                         plan=plan)
        for key, t in st._asdict().items():
            cache[key].copy_(t)
    if cfg.post_norms:
        h = layers.rmsnorm(p["norm1_post"], h)
    return _ffn_residual(p, x + h, cfg, plan, decode=True)[0]


@torch.no_grad()
def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: LMConfig, mesh=None):
    """One token: tokens (B, 1), pos (B,).  Returns (logits (B, V) f32,
    cache).  The cache is updated in place (the values of the reference's
    functional update); the same dict is returned.  An encoder-only model
    has no decode step: ``ValueError`` (the reference asserts).  With a
    ``mesh`` (an ``nn.module.Plan`` whose ``cache_len`` is the cache's
    global slot count, where "model" has several ranks) the call is this
    rank's share, as in ``forward``: ``params`` its blocks, ``tokens`` /
    ``pos`` its rows, ``cache`` its block under ``cache_axes`` (split-KV
    over "model"); the logits are its rows', whole over the vocabulary;
    the MoE blocks take the decode paths (``moe_dense_ep_2d`` /
    ``moe_dense_ep``)."""
    if cfg.encoder_only:
        raise ValueError(f"decode_step: {cfg.name} is encoder-only and has "
                         "no decode step")
    plan = _plan(cfg, mesh)
    lay = _layout(cfg, plan)
    emb = _take({"embed": params["embed"]}, lay, cfg, plan)["embed"]
    x = _embed(emb, tokens, cfg, plan)
    for g in range(cfg.n_groups):
        gp = _group(params["layers"], g)
        for j, kind in enumerate(cfg.pattern):
            x = _block_decode(kind, gp[f"b{j}"], x,
                              _group(cache[f"b{j}"], g), pos, cfg, plan,
                              lay and _grouped(lay["layers"][f"b{j}"]))
    for j, kind in enumerate(cfg.tail_pattern):
        x = _block_decode(kind, params[f"tail{j}"], x, cache[f"tail{j}"],
                          pos, cfg, plan, lay and lay[f"tail{j}"])
    return _logits(params, x, cfg, plan, lay)[:, 0], cache


# ===========================================================================
# Input cells (the dry run's stand-ins)
# ===========================================================================

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def batch_specs(cfg: LMConfig, shape_name: str,
                batch_override: int | None = None,
                seq_override: int | None = None, *,
                device="meta") -> dict:
    """Empty tensors standing for the data batch of a shape cell (the
    reference's ``ShapeDtypeStruct``s: the same keys and shapes), on
    ``device`` (``meta`` by default: shapes and dtypes, no storage).
    Tokens, targets and positions are int64, the port's token dtype;
    frames and patches f32, the loss mask int32."""
    sh = SHAPES[shape_name]
    b = batch_override or sh["batch"]
    s = seq_override or sh["seq"]
    f32, i32, tok = torch.float32, torch.int32, torch.int64

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    if sh["kind"] in ("train", "prefill"):
        if cfg.frontend == "audio_frames":
            return {"frames": empty((b, s, cfg.frontend_dim), f32),
                    "targets": empty((b, s), tok),
                    "loss_mask": empty((b, s), i32)}
        if cfg.frontend == "vision_patches":
            return {"tokens": empty((b, s - cfg.n_patches), tok),
                    "patches": empty((b, cfg.n_patches, cfg.frontend_dim),
                                     f32)}
        return {"tokens": empty((b, s), tok)}
    return {"tokens": empty((b, 1), tok), "pos": empty((b,), tok)}


def batch_axes(cfg: LMConfig, shape_name: str) -> dict:
    """The logical axes of each ``batch_specs`` leaf: a rank of a mesh
    takes its block of each (``nn.module.blocks_like``) under the
    config's ``sharding_overrides``, the sequence over "model" where they
    put it there (Megatron sequence parallelism) and it divides."""
    sh = SHAPES[shape_name]
    if sh["kind"] in ("train", "prefill"):
        if cfg.frontend == "audio_frames":
            return {"frames": ("batch", "seq", None),
                    "targets": ("batch", "seq"), "loss_mask": ("batch", "seq")}
        if cfg.frontend == "vision_patches":
            return {"tokens": ("batch", "seq"),
                    "patches": ("batch", None, None)}
        return {"tokens": ("batch", "seq")}
    return {"tokens": ("batch", None), "pos": ("batch",)}
