"""GQA attention: the flash kernel for full-sequence and prefill attention,
cache-based decode, QKV bias (qwen2.5).

Counterpart of ``repro.nn.attention``.  The reference computes full-sequence
attention with XLA's ``blockwise_attention``; for global attention without
a softcap that is the function of its Pallas ``_flash_kernel``, whose
counterpart here (``kernels.flash_attention.flash_attention_fwd``) ``mha``
calls: the CUDA kernel for a CUDA tensor, its plain version for a CPU one.
Sliding-window attention, attention softcaps and the quantized-cache
decode (``mha_decode_quant``) come with a later slice (ROADMAP, Queue 1
item 13).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.nn import layers

NEG_INF = -1e30


def attention_specs(d_model: int, n_heads: int, n_kv: int, head_dim: int,
                    qkv_bias: bool = False, dtype=torch.float32) -> dict:
    return {
        "wq": layers.linear_spec(d_model, n_heads * head_dim, "embed",
                                 "heads", bias=qkv_bias, dtype=dtype),
        "wk": layers.linear_spec(d_model, n_kv * head_dim, "embed",
                                 "kv_heads", bias=qkv_bias, dtype=dtype),
        "wv": layers.linear_spec(d_model, n_kv * head_dim, "embed",
                                 "kv_heads", bias=qkv_bias, dtype=dtype),
        "wo": layers.linear_spec(n_heads * head_dim, d_model, "heads",
                                 "embed", dtype=dtype),
    }


def _split_heads(x, n, hd):
    return x.reshape(*x.shape[:-1], n, hd)


def _repeat_kv(k, n_rep):
    """Each kv head repeated ``n_rep`` times in place (``jnp.repeat``)."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=-2)


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> (B * H, S, hd), contiguous."""
    b, s, h, hd = x.shape
    return x.transpose(1, 2).reshape(b * h, s, hd).contiguous()


def mha(p: dict, x: torch.Tensor, positions: torch.Tensor, *, n_heads: int,
        n_kv: int, head_dim: int, causal: bool = True,
        rope_theta: float = 10000.0, use_rope: bool = True,
        return_kv: bool = False):
    """Full-sequence attention layer, x (B, S, D); with ``return_kv`` also
    the roped, unrepeated (k, v), (B, S, n_kv, hd) each."""
    q = _split_heads(layers.linear(p["wq"], x), n_heads, head_dim)
    k = _split_heads(layers.linear(p["wk"], x), n_kv, head_dim)
    v = _split_heads(layers.linear(p["wv"], x), n_kv, head_dim)
    if use_rope:
        q = layers.rope(q, positions, rope_theta)
        k = layers.rope(k, positions, rope_theta)
    kv = (k, v)
    n_rep = n_heads // n_kv
    kr, vr = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    b, s = x.shape[:2]
    o = flash_attention_fwd(_heads_first(q), _heads_first(kr),
                            _heads_first(vr), causal=causal)
    o = o.reshape(b, n_heads, s, head_dim).transpose(1, 2)
    out = layers.linear(p["wo"], o.reshape(b, s, n_heads * head_dim))
    if return_kv:
        return out, kv
    return out


def prefill_cache_from_kv(k: torch.Tensor, v: torch.Tensor) -> dict:
    """Prefill-computed (roped) K/V as the decode cache of a global
    attention layer: the cache is (k, v) itself."""
    return {"k": k, "v": v}


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_max, n_kv, hd)
    v: torch.Tensor          # (B, S_max, n_kv, hd)


def mha_decode(p: dict, x: torch.Tensor, cache: KVCache, pos: torch.Tensor,
               *, n_heads: int, n_kv: int, head_dim: int,
               attn_softcap: float | None = None,
               rope_theta: float = 10000.0,
               use_rope: bool = True) -> tuple[torch.Tensor, KVCache]:
    """x (B, 1, D); pos (B,) the current length.  Returns (out, cache).

    The new K/V are written into ``cache`` in place at each row's
    position: the values the reference's one-hot update gives (every other
    slot times 1 plus 0, the written one times 0 plus the new value),
    without a second copy of the cache.  A row at or past ``s_max`` has an
    all-zero one-hot row in the reference, so its cache is left as it is:
    the write goes to the last slot and puts its old value back, which
    needs no host sync on ``pos`` and indexes nothing out of bounds.  The
    cache is written through a flat view, so it must be contiguous.
    """
    b = x.shape[0]
    s_max = cache.k.shape[1]
    q = _split_heads(layers.linear(p["wq"], x), n_heads, head_dim)
    k_new = _split_heads(layers.linear(p["wk"], x), n_kv, head_dim)
    v_new = _split_heads(layers.linear(p["wv"], x), n_kv, head_dim)
    if use_rope:
        q = layers.rope(q, pos[:, None], rope_theta)
        k_new = layers.rope(k_new, pos[:, None], rope_theta)

    # row i's slot in the cache seen as (B * S_max, n_kv, hd)
    slot = torch.clamp(pos, max=s_max - 1) + torch.arange(
        0, b * s_max, s_max, device=x.device)
    past = (pos >= s_max)[:, None, None]
    for buf, new in ((cache.k, k_new), (cache.v, v_new)):
        flat = buf.view(b * s_max, *buf.shape[2:])
        flat.index_copy_(0, slot, torch.where(
            past, flat.index_select(0, slot), new[:, 0].to(buf.dtype)))

    n_rep = n_heads // n_kv
    kk = _repeat_kv(cache.k, n_rep)                           # (B,S,H,hd)
    vv = _repeat_kv(cache.v, n_rep)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk).float()
    s = s / (head_dim ** 0.5)
    s = layers.softcap(s, attn_softcap)
    span = torch.arange(s_max, device=x.device)
    valid = span[None, :] <= pos[:, None]                     # causal fill
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w.to(vv.dtype), vv)
    out = layers.linear(p["wo"], o.reshape(b, 1, n_heads * head_dim))
    return out, cache
