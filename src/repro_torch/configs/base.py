"""Config helpers: reduced-config factory for CPU smoke tests + the
optimized perf profile (the knobs ACCEPTED by the §Perf hillclimbs).

Counterpart of ``repro.configs.base``, the same functions of the same
fields."""

from __future__ import annotations

import dataclasses

from repro_torch.models.lm import LMConfig


def optimized(cfg: LMConfig, *, serving: bool = False) -> LMConfig:
    """Apply the §Perf-accepted knobs (EXPERIMENTS.md):

    - MoE: int8 dispatch wire + capacity 1.0 (kimi ladder, confirmed);
    - training: dots remat policy (kimi + nemotron ladders, confirmed;
      costs ~15-40 % more activation memory — size the mesh accordingly);
    - serving: int8 KV cache (qwen ladder, confirmed; int4 available via
      kv_quant="int4" with an accuracy-risk note).

    Registry defaults stay paper-faithful so the §Roofline baseline table
    remains the reproduction; this profile is the beyond-paper state.
    """
    kw: dict = {"remat_policy": "dots"}
    if cfg.moe:
        kw.update(moe_wire_dtype="int8", moe_capacity_factor=1.0)
    if serving:
        kw.update(kv_quant="int8")
    return dataclasses.replace(cfg, **kw)


def reduced(cfg: LMConfig, *, n_layers: int | None = None, d_model: int = 64,
            vocab: int = 128) -> LMConfig:
    """Shrink an architecture to smoke-test size, preserving its *family
    structure* (pattern, GQA ratio, MoE routing, frontends, softcaps)."""
    heads = max(2, min(cfg.n_heads, 4))
    # preserve the GQA ratio where possible
    ratio = max(1, cfg.n_heads // cfg.n_kv)
    n_kv = max(1, heads // ratio)
    nl = n_layers or max(len(cfg.pattern),
                         2 * len(cfg.pattern) + len(cfg.tail_pattern))
    return dataclasses.replace(
        cfg,
        n_layers=nl,
        d_model=d_model,
        n_heads=heads,
        n_kv=n_kv,
        head_dim=d_model // heads if cfg.head_dim else 0,
        d_ff=d_model * 2 if cfg.d_ff else 0,
        d_rnn=d_model if cfg.d_rnn else 0,
        vocab_size=vocab,
        n_experts=8 if cfg.moe else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe else 0,
        window=32 if cfg.window else None,
        frontend_dim=16 if cfg.frontend_dim else 0,
        n_patches=4 if cfg.n_patches else 0,
        attn_chunk=64,
        dtype="float32",
        remat=False,
        vocab_pad_to=16,
    )
