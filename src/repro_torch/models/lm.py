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
reference's expert-parallel paths (``_moe_apply``).  Under a mesh a
rank holds its blocks of the parameters (``nn.module.param_layout``
under the config's ``sharding_overrides``); the entry points gather the
leaves outside the experts whole for the call (``_mesh_params``) and run
the dense layers on them, with the full activations, on every rank; the
MoE blocks take their expert blocks as held and split their work.  The
modality frontends are the reference's stubs: precomputed audio frames
or ViT patch embeddings through a learned projector.  An encoder-only
model has no decode step, here as in the reference.

Training (``features``, ``loss_fn``) runs under autograd: attention
takes the plain ``blockwise_attention`` there (the flash kernel has no
backward), and ``remat`` recomputes each layer group (``remat_mode``
"group") or each attention call ("attn_only"), and always the head with
its cross-entropy, in the backward (``torch.utils.checkpoint``, where
the reference has ``jax.checkpoint``).  Every ``remat_policy`` saves
nothing inside the recomputed unit here: the policy chooses what the
reference keeps, which moves memory, not a value.  ``forward`` and
``decode_step`` are serving's and run under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch import device as device_lib
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
    remat_policy: str = "nothing"    # nothing | dots
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

def _ffn_apply(p: dict, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    lin = layers.cim_linear if cfg.cim_linear else layers.linear
    act = layers.ACTIVATIONS[cfg.activation]
    h = act(lin(p["w_in"], x))
    if cfg.gated_ffn:
        h = h * lin(p["w_gate"], x)
    if cfg.kwn_ffn_k > 0:
        # Eq. (1) on FFN units: keep the top-k magnitudes per token (ties
        # at the k-th kept too), zero the rest.
        thresh = torch.topk(torch.abs(h), cfg.kwn_ffn_k, dim=-1
                            ).values[..., -1:]
        h = torch.where(torch.abs(h) >= thresh, h, torch.zeros_like(h))
    return lin(p["w_out"], h)


def _moe_apply(p: dict, x: torch.Tensor, cfg: LMConfig, mesh=None,
               decode: bool = False):
    """The MoE FFN: the experts, then arctic's dense residual FFN, then
    kimi's shared experts, added in that order.  Returns (y, aux, or None
    in a decode step, whose aux the reference discards).

    The experts' path is the reference's choice: ``moe_ref`` with no
    mesh; with one, ``moe_2d`` (``moe_dense_ep_2d`` to decode) where the
    config's ``sharding_overrides`` lay the experts over the DP rows, else
    ``moe_a2a`` (sequence-sharded where the overrides shard ``seq`` over
    "model") or ``moe_dense_ep`` to decode."""
    overrides = cfg.sharding_overrides or {}
    experts_rule = overrides.get("experts", "model")
    is_2d = experts_rule not in (None, "model")   # experts over DP rows
    kw = dict(k=cfg.moe_top_k, activation=cfg.activation)
    if mesh is not None:
        kw["specs"] = module.param_layout(
            moe.moe_specs(cfg.d_model, cfg.d_ff, cfg.n_experts), mesh,
            overrides)
    if mesh is None:
        y, aux = moe.moe_ref(p["moe"], x, with_aux=not decode, **kw)
    elif is_2d and not decode:
        y, aux = moe.moe_2d(p["moe"], x, mesh=mesh,
                            expert_axes=tuple(experts_rule),
                            capacity_factor=cfg.moe_capacity_factor,
                            wire_dtype=cfg.moe_wire_dtype, **kw)
    elif is_2d:
        y, aux = moe.moe_dense_ep_2d(p["moe"], x, mesh=mesh,
                                     expert_axes=tuple(experts_rule), **kw)
    elif decode:
        y, aux = moe.moe_dense_ep(p["moe"], x, mesh=mesh, **kw)
    else:
        y, aux = moe.moe_a2a(p["moe"], x, mesh=mesh,
                             seq_sharded=overrides.get("seq") == "model",
                             **kw)
    if decode:
        aux = None
    if cfg.moe_dense_residual:
        y = y + _ffn_apply(p["ffn"], x, cfg)
    if cfg.n_shared_experts:
        y = y + _ffn_apply(p["shared"], x, cfg)
    return y, aux


def _ffn_residual(p: dict, x: torch.Tensor, cfg: LMConfig, mesh=None,
                  decode: bool = False):
    """The block's FFN half: (x + FFN(norm2(x)), aux loss f32, or None
    without MoE or in a decode step)."""
    aux = None
    if "norm2" not in p:
        return x, aux
    h = layers.rmsnorm(p["norm2"], x)
    if cfg.moe:
        h, aux = _moe_apply(p, h, cfg, mesh, decode)
    else:
        h = _ffn_apply(p["ffn"], h, cfg)
    if cfg.post_norms:
        h = layers.rmsnorm(p["norm2_post"], h)
    return x + h, aux


def _block_apply(kind: str, p: dict, x: torch.Tensor,
                 positions: torch.Tensor, cfg: LMConfig,
                 prefill: bool = False, mesh=None):
    """One block.  Returns (x, aux loss or None, cache entry or None): K/V
    (ring-ordered with ``slot_pos`` for a local layer over a prompt longer
    than its window, quantized for a global one under ``kv_quant``) or the
    recurrent state.  Attention is causal unless the model is
    encoder-only."""
    h = layers.rmsnorm(p["norm1"], x)
    cache = None
    if kind in ("attn", "attn_local"):
        window = cfg.window if kind == "attn_local" else None
        attn = functools.partial(
            attention.mha, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
            head_dim=cfg.hd, causal=not cfg.encoder_only, window=window,
            attn_softcap=cfg.attn_softcap, rope_theta=cfg.rope_theta,
            chunk=cfg.attn_chunk, return_kv=prefill)
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
    elif kind == "mlstm":
        h = recurrent.mlstm_forward(p["cell"], h, cfg.n_heads,
                                    return_state=prefill)
    elif kind == "slstm":
        h = recurrent.slstm_forward(p["cell"], h, cfg.n_heads,
                                    return_state=prefill)
    elif kind == "rglru":
        h = recurrent.rglru_forward(p["cell"], h, return_state=prefill)
    if prefill and cache is None:
        h, st = h
        cache = st._asdict()
    if cfg.post_norms:
        h = layers.rmsnorm(p["norm1_post"], h)
    x, aux = _ffn_residual(p, x + h, cfg, mesh)
    return x, aux, cache


def _remat(fn):
    """``fn`` recomputed in the backward instead of keeping what it
    saves (the reference's ``jax.checkpoint`` with nothing saveable);
    called as it is where autograd records nothing."""
    @functools.wraps(fn)
    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return run


def _embed_inputs(params: dict, batch: dict, cfg: LMConfig) -> torch.Tensor:
    """The model's input sequence (B, S, D): audio frames (B, S,
    frontend_dim) through ``frontend_proj``; else the token embeddings,
    after the ViT patches (B, n_patches, frontend_dim) through
    ``patch_proj`` for the VLM."""
    if cfg.frontend == "audio_frames":
        return layers.linear(params["frontend_proj"],
                             batch["frames"].to(cfg.compute_dtype))
    x = layers.embed(params["embed"], batch["tokens"],
                     scale_by_dim=cfg.scale_embed).to(cfg.compute_dtype)
    if cfg.frontend == "vision_patches":
        patches = layers.linear(params["patch_proj"],
                                batch["patches"].to(cfg.compute_dtype))
        x = torch.cat([patches, x], dim=1)
    return x


def _group(tree: dict, g: int) -> dict:
    """Group ``g``'s slice of a stacked tree (views, no copies)."""
    return tree_map(lambda t: t[g], tree)


def _logits(params: dict, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """f32 logits: the vocabulary padded to ``padded_vocab``, or an
    encoder-only model's ``vocab_size`` classes."""
    x = layers.rmsnorm(params["final_norm"], x)
    if cfg.tie_embeddings and not cfg.encoder_only:
        logits = layers.unembed(params["embed"], x)
    else:
        logits = layers.linear(params["head"], x)
    return layers.softcap(logits.float(), cfg.final_softcap)


def _add_aux(acc, aux):
    """``acc + aux`` where None stands for 0: the reference's sum from
    zeros (0 + a is a in f32), with no tensor made or added for blocks
    without MoE."""
    if aux is None:
        return acc
    return aux if acc is None else acc + aux


def _mesh_params(params: dict, cfg: LMConfig, mesh) -> dict:
    """The parameters a call under ``mesh`` computes with: from this
    rank's blocks (``nn.module.param_layout`` of ``param_specs`` under
    the config's overrides), every leaf outside an MoE block's experts
    gathered whole (``nn.module.gather_param``), the ``moe`` leaves left
    as blocks for the expert-parallel paths.  ``mesh=None``: ``params``
    as they are."""
    if mesh is None:
        return params
    layout = module.param_layout(param_specs(cfg), mesh,
                                 cfg.sharding_overrides)

    def walk(p, spec, key):
        if isinstance(p, dict):
            return p if key == "moe" else {k: walk(p[k], spec[k], k)
                                           for k in p}
        return module.gather_param(p, spec, mesh)

    return walk(params, layout, None)


def _constrain_acts(x: torch.Tensor, cfg: LMConfig, mesh) -> torch.Tensor:
    """The identity.  The reference's ``_constrain_acts`` is a sharding
    constraint (Megatron sequence parallelism of the residual stream over
    "model"), a layout that changes no number; here every rank holds the
    full activations (the MoE paths take and return them whole), so
    there is nothing to lay out."""
    return x


@torch.no_grad()
def forward(params: dict, batch: dict, cfg: LMConfig, prefill: bool = False,
            *, mesh=None):
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
    sums it (0 without MoE).  With a ``mesh`` (``launch.mesh``)
    ``params`` are this rank's blocks (``_mesh_params``), the MoE blocks
    take the reference's expert-parallel paths (``_moe_apply``), and
    every rank returns the same full results; every rank of the mesh
    must make the call.
    """
    params = _mesh_params(params, cfg, mesh)
    x = _constrain_acts(_embed_inputs(params, batch, cfg), cfg, mesh)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    caches: dict[str, list] = {f"b{j}": [] for j in range(len(cfg.pattern))}
    aux = None
    for g in range(cfg.n_groups):
        gp = _group(params["layers"], g)
        aux_g = None
        for j, kind in enumerate(cfg.pattern):
            x, aux_b, c = _block_apply(kind, gp[f"b{j}"], x, positions, cfg,
                                       prefill, mesh)
            x = _constrain_acts(x, cfg, mesh)
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
                                   cfg, prefill, mesh)
        aux = _add_aux(aux, aux_t)
        if prefill:
            cache[f"tail{j}"] = c
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if prefill:
        return _logits(params, x[:, -1:], cfg)[:, 0], aux, cache
    return _logits(params, x, cfg), aux


# ===========================================================================
# Training: features, head + cross-entropy, loss
# ===========================================================================

def _groups(tree: dict, n: int) -> list[dict]:
    """The stacked tree's ``n`` group slices, each leaf unbound once: its
    backward stacks the groups' gradients into one tensor, where a slice
    a group would add a full-size zero-padded gradient for each."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda ts: ts[g], parts) for g in range(n)]


def features(params: dict, batch: dict, cfg: LMConfig, *, mesh=None):
    """The forward up to, not including, the unembedding: (x after
    ``final_norm`` (B, S, D), the aux loss f32, summed as ``forward``
    sums it).  Each layer group is recomputed in the backward under
    ``remat`` with ``remat_mode`` "group".  ``mesh`` as in ``forward``;
    the gradient of each block this rank holds is that block of the
    global function's gradient."""
    return _features(_mesh_params(params, cfg, mesh), batch, cfg, mesh)


def _features(params: dict, batch: dict, cfg: LMConfig, mesh):
    """``features`` on the parameters ``_mesh_params`` gives."""
    x = _constrain_acts(_embed_inputs(params, batch, cfg), cfg, mesh)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)

    def group_fn(x, gp):
        aux_g = None
        for j, kind in enumerate(cfg.pattern):
            x, aux_b, _ = _block_apply(kind, gp[f"b{j}"], x, positions, cfg,
                                       mesh=mesh)
            x = _constrain_acts(x, cfg, mesh)
            aux_g = _add_aux(aux_g, aux_b)
        return x, aux_g

    if cfg.remat and cfg.remat_mode == "group":
        group_fn = _remat(group_fn)
    aux = None
    for gp in _groups(params["layers"], cfg.n_groups):
        x, aux_g = group_fn(x, gp)
        aux = _add_aux(aux, aux_g)
    for j, kind in enumerate(cfg.tail_pattern):
        x, aux_t, _ = _block_apply(kind, params[f"tail{j}"], x, positions,
                                   cfg, mesh=mesh)
        aux = _add_aux(aux, aux_t)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return layers.rmsnorm(params["final_norm"], x), aux


def _cross_entropy(logits: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    """Per-position -log softmax(logits)[target], f32."""
    lse = torch.log_softmax(logits, dim=-1)
    return -torch.gather(lse, -1, targets.long()[..., None])[..., 0]


def _masked_mean(ce: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.float()
    return torch.sum(ce * m) / torch.clamp(torch.sum(m), min=1.0)


def _head_and_ce(params: dict, x: torch.Tensor, batch: dict,
                 cfg: LMConfig) -> torch.Tensor:
    """Unembedding and cross-entropy, f32.  A decoder predicts each next
    token over the padded vocabulary (the logits of the VLM's patch
    prefix dropped), averaged over the positions, or over those
    ``loss_mask`` keeps; an encoder-only model its ``targets`` over its
    classes where ``loss_mask`` is set."""
    if cfg.encoder_only:
        logits = layers.linear(params["head"], x).float()
        return _masked_mean(_cross_entropy(logits, batch["targets"]),
                            batch["loss_mask"])
    if cfg.tie_embeddings:
        logits = layers.unembed(params["embed"], x)
    else:
        logits = layers.linear(params["head"], x)
    logits = layers.softcap(logits.float(), cfg.final_softcap)
    n_prefix = cfg.n_patches if cfg.frontend == "vision_patches" else 0
    tokens = batch["tokens"]
    ce = _cross_entropy(logits[:, n_prefix:][:, :-1], tokens[:, 1:])
    mask = batch.get("loss_mask")
    if mask is not None:
        return _masked_mean(ce, mask[:, 1:])
    return torch.mean(ce)


def loss_fn(params: dict, batch: dict, cfg: LMConfig, *, mesh=None):
    """(ce + 0.01 * aux, {"ce", "aux"}), differentiable in ``params``.
    The head and cross-entropy are recomputed in the backward as one
    unit, so the (B, S, V) logits and their softmax are never kept.
    ``mesh`` as in ``features``."""
    params = _mesh_params(params, cfg, mesh)
    x, aux = _features(params, batch, cfg, mesh)
    head = {k: params[k] for k in ("head", "embed") if k in params}
    ce = _remat(_head_and_ce)(head, x, batch, cfg)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


# ===========================================================================
# Decode (serve_step)
# ===========================================================================

def _cache_spec_for(kind: str, cfg: LMConfig, batch: int, s_max: int,
                    device) -> dict:
    hd = cfg.hd
    if kind == "attn":
        if cfg.kv_quant:
            shape = (batch, s_max, cfg.n_kv,
                     kvq.storage_shape(hd, cfg.kv_quant))
            sd = kvq.storage_dtype(cfg.kv_quant)
            scale = (batch, s_max, cfg.n_kv, 1)
            return {"k": torch.zeros(shape, dtype=sd, device=device),
                    "v": torch.zeros(shape, dtype=sd, device=device),
                    "k_scale": torch.zeros(scale, device=device),
                    "v_scale": torch.zeros(scale, device=device)}
        shape = (batch, s_max, cfg.n_kv, hd)
        return {"k": torch.zeros(shape, dtype=cfg.compute_dtype,
                                 device=device),
                "v": torch.zeros(shape, dtype=cfg.compute_dtype,
                                 device=device)}
    if kind == "attn_local":
        w = min(cfg.window or s_max, s_max)
        shape = (batch, w, cfg.n_kv, hd)
        return {"k": torch.zeros(shape, dtype=cfg.compute_dtype,
                                 device=device),
                "v": torch.zeros(shape, dtype=cfg.compute_dtype,
                                 device=device),
                "slot_pos": torch.full((batch, w), -1, dtype=torch.int32,
                                       device=device)}
    hd_cell = cfg.d_model // cfg.n_heads
    if kind == "mlstm":
        st = recurrent.mlstm_init_state(batch, cfg.n_heads, hd_cell, device)
    elif kind == "slstm":
        st = recurrent.slstm_init_state(batch, cfg.n_heads, hd_cell, device)
    elif kind == "rglru":
        st = recurrent.rglru_init_state(batch, cfg.d_rnn or cfg.d_model,
                                        device=device)
    else:
        raise ValueError(kind)
    return {key: t.clone() for key, t in st._asdict().items()}


def init_cache(cfg: LMConfig, batch: int, s_max: int, device=None) -> dict:
    """A fresh decode cache on ``device`` (``cuda`` unless the caller
    passes ``device="cpu"``): for each pattern block its entry stacked
    over groups (G, B, ...), for each tail block (B, ...).  Global
    attention: K/V (B, s_max, n_kv, hd), or the int8 / int4 payload and
    f32 scales under ``kv_quant``; local attention: a ring of min(window,
    s_max) slots with ``slot_pos`` -1; recurrent blocks: their initial
    states."""
    dev = device_lib.resolve(device)
    cache = {}
    for j, kind in enumerate(cfg.pattern):
        one = _cache_spec_for(kind, cfg, batch, s_max, dev)
        cache[f"b{j}"] = {key: t.expand(cfg.n_groups, *t.shape).clone()
                          for key, t in one.items()}
    for j, kind in enumerate(cfg.tail_pattern):
        cache[f"tail{j}"] = _cache_spec_for(kind, cfg, batch, s_max, dev)
    return cache


def pad_cache(cache: dict, cfg: LMConfig, s_max: int) -> dict:
    """Grow a prefill-produced cache (seq = prompt length) to ``s_max``
    slots so decode can append: global-attention K/V (and scales) are
    zero-padded on the sequence dim (the third from the end); ring
    buffers and recurrent states are already final and stay as they
    are."""
    def pad(t: torch.Tensor) -> torch.Tensor:
        cur = t.shape[-3]
        if cur >= s_max:
            return t
        shape = list(t.shape)
        shape[-3] = s_max - cur
        return torch.cat([t, t.new_zeros(shape)], dim=-3)

    def pad_entry(entry: dict) -> dict:
        if "slot_pos" in entry or "k" not in entry:
            return entry
        return {key: pad(t) for key, t in entry.items()}

    return {name: pad_entry(entry) for name, entry in cache.items()}


def _ring_decode(p: dict, x: torch.Tensor, cache: dict, pos: torch.Tensor,
                 cfg: LMConfig) -> torch.Tensor:
    """Sliding-window ring-buffer decode of a local attention layer: the
    new K/V go to slot pos % w, written into ``cache`` in place with their
    position in ``slot_pos``; a slot is seen while its position is within
    the window."""
    if "slot_pos" not in cache:
        raise ValueError(
            "a local-attention cache without slot_pos: prefill over a "
            "prompt no longer than the window returns plain K/V, which the "
            "ring decode cannot continue (the reference raises KeyError "
            "here); prefill a prompt longer than the window, or decode "
            "token by token from init_cache")
    b = x.shape[0]
    w = cache["k"].shape[1]
    q, k_new, v_new = attention._qkv_decode(p, x, pos, cfg.n_heads, cfg.n_kv,
                                            cfg.hd, cfg.rope_theta, True)
    slot = pos % w
    attention.write_rows(cache["k"], slot, k_new[:, 0])
    attention.write_rows(cache["v"], slot, v_new[:, 0])
    attention.write_rows(cache["slot_pos"], slot, pos)
    slot_pos = cache["slot_pos"]
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None]) & \
        (slot_pos > pos[:, None] - (cfg.window or w))
    o = attention._attend(q, cache["k"], cache["v"], valid, cfg.hd,
                          cfg.attn_softcap, cfg.n_heads // cfg.n_kv)
    return layers.linear(p["wo"], o.reshape(b, 1, cfg.n_heads * cfg.hd))


_STATES = {"mlstm": (recurrent.MLSTMState, recurrent.mlstm_decode_step),
           "slstm": (recurrent.SLSTMState, recurrent.slstm_decode_step),
           "rglru": (recurrent.RGLRUState, recurrent.rglru_decode_step)}


def _block_decode(kind: str, p: dict, x: torch.Tensor, cache: dict,
                  pos: torch.Tensor, cfg: LMConfig,
                  mesh=None) -> torch.Tensor:
    """One block's decode step; its cache entry is updated in place."""
    h = layers.rmsnorm(p["norm1"], x)
    if kind == "attn" and cfg.kv_quant:
        h, _ = attention.mha_decode_quant(
            p["attn"], h, cache, pos, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
            head_dim=cfg.hd, kv_quant=cfg.kv_quant,
            attn_softcap=cfg.attn_softcap, rope_theta=cfg.rope_theta)
    elif kind == "attn":
        h, _ = attention.mha_decode(
            p["attn"], h, attention.KVCache(cache["k"], cache["v"]), pos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
            attn_softcap=cfg.attn_softcap, rope_theta=cfg.rope_theta)
    elif kind == "attn_local":
        h = _ring_decode(p["attn"], h, cache, pos, cfg)
    else:
        state_cls, step = _STATES[kind]
        st = state_cls(**{key: cache[key] for key in state_cls._fields})
        if kind == "rglru":
            h, st = step(p["cell"], h, st)
        else:
            h, st = step(p["cell"], h, st, cfg.n_heads)
        for key, t in st._asdict().items():
            cache[key].copy_(t)
    if cfg.post_norms:
        h = layers.rmsnorm(p["norm1_post"], h)
    return _ffn_residual(p, x + h, cfg, mesh, decode=True)[0]


@torch.no_grad()
def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: LMConfig, *, mesh=None):
    """One token: tokens (B, 1), pos (B,).  Returns (logits (B, V) f32,
    cache).  The cache is updated in place (the values of the reference's
    functional update); the same dict is returned.  An encoder-only model
    has no decode step: ``ValueError`` (the reference asserts).  With a
    ``mesh``, ``params`` are this rank's blocks as in ``forward``, the
    MoE blocks take the decode paths (``moe_dense_ep_2d`` /
    ``moe_dense_ep``) and every rank holds the same full cache."""
    if cfg.encoder_only:
        raise ValueError(f"decode_step: {cfg.name} is encoder-only and has "
                         "no decode step")
    params = _mesh_params(params, cfg, mesh)
    x = layers.embed(params["embed"], tokens,
                     scale_by_dim=cfg.scale_embed).to(cfg.compute_dtype)
    for g in range(cfg.n_groups):
        gp = _group(params["layers"], g)
        for j, kind in enumerate(cfg.pattern):
            x = _block_decode(kind, gp[f"b{j}"], x,
                              _group(cache[f"b{j}"], g), pos, cfg, mesh)
    for j, kind in enumerate(cfg.tail_pattern):
        x = _block_decode(kind, params[f"tail{j}"], x, cache[f"tail{j}"],
                          pos, cfg, mesh)
    return _logits(params, x, cfg)[:, 0], cache
