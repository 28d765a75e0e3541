"""The LM family's dense-attention path: a repeating block pattern over
layer groups, prefill, and cache-based decode.

Counterpart of ``repro.models.lm`` for ``"attn"`` blocks: the parameters
are the reference's nested dict (stacked ``layers/b{j}`` tensors with the
group dimension first, then ``tail{j}`` blocks), and its ``lax.scan`` over
groups is a Python loop here.  Paper integration points carried along:
CIM-mode projections (``cim_linear``: ternary twin-cell weights and NLQ
activations, paper C1/C2) and KWN-FFN activation sparsity (``kwn_ffn_k``,
Eq. 1 with the FFN units as the neuron bank).

Full-sequence attention goes through the flash kernel
(``nn.attention.mha``).  Configurations this slice does not carry
(local attention, recurrent blocks, MoE, a quantized KV cache, modality
frontends, encoder-only models, attention softcaps in the full-sequence
forward) raise ``NotImplementedError`` naming the ROADMAP item that ports
them.  Remat and chunking fields (``remat*``, ``attn_chunk``) shape the
reference's training memory and do not change a forward's value; they
are data here.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import device as device_lib
from repro_torch.nn import attention, layers
from repro_torch.nn.module import ParamSpec, count_params, tree_map

_ROADMAP = "ROADMAP.md, Queue 1 item 13 (the rest of the LM stack)"


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
        """Params touched per token (MoE: only the top-k experts count)."""
        if self.moe:
            raise NotImplementedError(f"MoE configs ({self.name}): "
                                      f"nn/moe.py is not ported yet; "
                                      f"{_ROADMAP}")
        return self.param_count()


def _unsupported(cfg: LMConfig, full_sequence: bool) -> str | None:
    """Why this slice cannot run ``cfg``, or None."""
    kinds = set(cfg.pattern)
    if kinds - {"attn"} or cfg.window is not None:
        return (f"block kinds {sorted(kinds - {'attn'})} / window "
                f"{cfg.window} (local attention and recurrent blocks)")
    if cfg.moe:
        return "MoE FFNs (nn/moe.py)"
    if cfg.kv_quant:
        return f"a {cfg.kv_quant} KV cache (nn/kvq.py, mha_decode_quant)"
    if cfg.frontend is not None:
        return f"the {cfg.frontend} frontend"
    if cfg.encoder_only:
        return "encoder-only models"
    if full_sequence and cfg.attn_softcap is not None:
        return "attention softcaps in the full-sequence forward"
    return None


def _require_supported(cfg: LMConfig, where: str,
                       full_sequence: bool = False) -> None:
    why = _unsupported(cfg, full_sequence)
    if why is not None:
        raise NotImplementedError(
            f"{where}: {cfg.name} needs {why}, which this port does not "
            f"carry yet; {_ROADMAP}")


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
    if kind not in ("attn", "attn_local") or cfg.moe:
        raise NotImplementedError(
            f"param_specs: {cfg.name} has {kind!r} blocks"
            f"{' and MoE FFNs' if cfg.moe else ''}; {_ROADMAP}")
    s: dict[str, Any] = {"norm1": layers.norm_spec(d)}
    s["attn"] = attention.attention_specs(d, cfg.n_heads, cfg.n_kv, cfg.hd,
                                          cfg.qkv_bias)
    if cfg.post_norms:
        s["norm1_post"] = layers.norm_spec(d)
    if cfg.d_ff > 0:
        s["norm2"] = layers.norm_spec(d)
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


def _ffn_residual(p: dict, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    if "norm2" not in p:
        return x
    h = _ffn_apply(p["ffn"], layers.rmsnorm(p["norm2"], x), cfg)
    if cfg.post_norms:
        h = layers.rmsnorm(p["norm2_post"], h)
    return x + h


def _block_apply(p: dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: LMConfig, prefill: bool = False):
    """One ``"attn"`` block.  Returns (x, cache entry or None)."""
    h = layers.rmsnorm(p["norm1"], x)
    h = attention.mha(p["attn"], h, positions, n_heads=cfg.n_heads,
                      n_kv=cfg.n_kv, head_dim=cfg.hd,
                      causal=not cfg.encoder_only,
                      rope_theta=cfg.rope_theta, return_kv=prefill)
    cache = None
    if prefill:
        h, (k, v) = h
        cache = attention.prefill_cache_from_kv(k, v)
    if cfg.post_norms:
        h = layers.rmsnorm(p["norm1_post"], h)
    return _ffn_residual(p, x + h, cfg), cache


def _embed_inputs(params: dict, batch: dict, cfg: LMConfig) -> torch.Tensor:
    return layers.embed(params["embed"], batch["tokens"],
                        scale_by_dim=cfg.scale_embed).to(cfg.compute_dtype)


def _group(tree: dict, g: int) -> dict:
    """Group ``g``'s slice of a stacked tree (views, no copies)."""
    return tree_map(lambda t: t[g], tree)


def _logits(params: dict, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    x = layers.rmsnorm(params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = layers.unembed(params["embed"], x)
    else:
        logits = layers.linear(params["head"], x)
    return layers.softcap(logits.float(), cfg.final_softcap)


@torch.no_grad()
def forward(params: dict, batch: dict, cfg: LMConfig, prefill: bool = False):
    """Returns (logits, aux_loss[, cache]).

    ``prefill=True`` is the serving prefill: logits of the LAST position
    only (B, V), and the per-layer decode cache (roped K/V, (B, S, n_kv,
    hd) a layer, stacked over groups).  The full forward returns logits
    (B, S, V).  Logits are f32; the aux loss is 0 (no MoE here).
    """
    _require_supported(cfg, "forward", full_sequence=True)
    x = _embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    caches: dict[str, list] = {f"b{j}": [] for j in range(len(cfg.pattern))}
    for g in range(cfg.n_groups):
        gp = _group(params["layers"], g)
        for j in range(len(cfg.pattern)):
            x, c = _block_apply(gp[f"b{j}"], x, positions, cfg, prefill)
            if prefill:
                caches[f"b{j}"].append(c)
    cache: dict[str, dict] = {}
    if prefill:
        cache = {name: {key: torch.stack([c[key] for c in entries])
                        for key in ("k", "v")}
                 for name, entries in caches.items()}
    for j in range(len(cfg.tail_pattern)):
        x, c = _block_apply(params[f"tail{j}"], x, positions, cfg, prefill)
        if prefill:
            cache[f"tail{j}"] = c
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if prefill:
        return _logits(params, x[:, -1:], cfg)[:, 0], aux, cache
    return _logits(params, x, cfg), aux


# ===========================================================================
# Decode (serve_step)
# ===========================================================================

def _cache_spec_for(cfg: LMConfig, batch: int, s_max: int,
                    device) -> dict:
    shape = (batch, s_max, cfg.n_kv, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}


def init_cache(cfg: LMConfig, batch: int, s_max: int, device=None) -> dict:
    """A zero decode cache, K/V (G, B, s_max, n_kv, hd) for each pattern
    block and (B, s_max, n_kv, hd) for each tail block, on ``device``
    (``cuda`` unless the caller passes ``device="cpu"``)."""
    _require_supported(cfg, "init_cache")
    dev = device_lib.resolve(device)
    cache = {}
    for j in range(len(cfg.pattern)):
        one = _cache_spec_for(cfg, batch, s_max, dev)
        cache[f"b{j}"] = {key: t.expand(cfg.n_groups, *t.shape).clone()
                          for key, t in one.items()}
    for j in range(len(cfg.tail_pattern)):
        cache[f"tail{j}"] = _cache_spec_for(cfg, batch, s_max, dev)
    return cache


def pad_cache(cache: dict, cfg: LMConfig, s_max: int) -> dict:
    """Grow a prefill-produced cache (seq = prompt length) to ``s_max``
    slots so decode can append: K/V are zero-padded on the sequence dim
    (the third dim from the end)."""
    def pad(t: torch.Tensor) -> torch.Tensor:
        cur = t.shape[-3]
        if cur >= s_max:
            return t
        shape = list(t.shape)
        shape[-3] = s_max - cur
        return torch.cat([t, t.new_zeros(shape)], dim=-3)

    return {name: {key: pad(t) for key, t in entry.items()}
            for name, entry in cache.items()}


def _block_decode(p: dict, x: torch.Tensor, cache: dict, pos: torch.Tensor,
                  cfg: LMConfig) -> torch.Tensor:
    h = layers.rmsnorm(p["norm1"], x)
    h, _ = attention.mha_decode(
        p["attn"], h, attention.KVCache(cache["k"], cache["v"]), pos,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
        attn_softcap=cfg.attn_softcap, rope_theta=cfg.rope_theta)
    if cfg.post_norms:
        h = layers.rmsnorm(p["norm1_post"], h)
    return _ffn_residual(p, x + h, cfg)


@torch.no_grad()
def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: LMConfig):
    """One token: tokens (B, 1), pos (B,).  Returns (logits (B, V) f32,
    cache).  The new K/V are written into ``cache`` in place (the values
    of the reference's functional update); the same dict is returned."""
    _require_supported(cfg, "decode_step")
    x = layers.embed(params["embed"], tokens,
                     scale_by_dim=cfg.scale_embed).to(cfg.compute_dtype)
    for g in range(cfg.n_groups):
        gp = _group(params["layers"], g)
        for j in range(len(cfg.pattern)):
            x = _block_decode(gp[f"b{j}"], x, _group(cache[f"b{j}"], g),
                              pos, cfg)
    for j in range(len(cfg.tail_pattern)):
        x = _block_decode(params[f"tail{j}"], x, cache[f"tail{j}"], pos, cfg)
    return _logits(params, x, cfg)[:, 0], cache
