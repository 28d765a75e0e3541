"""GQA attention: the flash kernel for full-sequence and prefill attention,
the blockwise online softmax where the flash kernel does not apply
(sliding windows, logit softcaps), cache-based decode (full precision and
int8 / int4), QKV bias (qwen2.5).

Counterpart of ``repro.nn.attention``.  The reference computes
full-sequence attention with XLA's ``blockwise_attention``; for attention
without a softcap whose window (if any) spans the sequence, that is the
function of its Pallas ``_flash_kernel``, whose counterpart here
(``kernels.flash_attention.flash_attention_fwd``) ``mha`` calls: the CUDA
kernel for a CUDA tensor, its plain version for a CPU one.  Everywhere
else, and under autograd (training: the kernel has no backward),
``mha`` calls the plain ``blockwise_attention``, as the JAX package
does outside Pallas: a loop over KV chunks carrying (acc, row max, row
sum), or for a window shorter than the sequence each window-sized block
against itself and the block before it.  Where the reference asserts
that the sequence divides into chunks or windows, this raises
``ValueError``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.dist import collectives
from repro_torch.nn import kvq, layers

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


def _chunk_attn_step(q, k_c, v_c, mask, softcap, scale):
    """q (B, cq, H, hd); k_c / v_c (B, ck, H, hd); mask broadcastable to
    (B, H, cq, ck) or None.  Returns the unnormalised (exp(scores) @ v,
    row max, row sum)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_c).float() * scale
    s = layers.softcap(s, softcap)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1)                                 # (B,H,cq)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v_c.dtype), v_c)
    return o, m, l


def _rows(t: torch.Tensor, dtype) -> torch.Tensor:
    """(B, H, cq) -> (B, cq, H, 1) in ``dtype``: a per-row factor of o."""
    return t.transpose(1, 2)[..., None].to(dtype)


def blockwise_attention(q, k, v, *, causal: bool = True,
                        window: int | None = None,
                        softcap: float | None = None,
                        chunk: int = 1024) -> torch.Tensor:
    """q, k, v (B, S, H, hd), kv already head-repeated -> (B, S, H, hd).

    The reference's loop over KV chunks visits the chunks after a causal
    query chunk too and masks them whole; their weight in the online
    softmax is exactly 0 (exp(-1e30 - m) underflows), so they are skipped
    here with the same result."""
    b, s, h, hd = q.shape
    scale = 1.0 / (hd ** 0.5)

    if window is not None and window < s:
        return _sliding_window_attention(q, k, v, window=window,
                                         softcap=softcap, scale=scale)

    if s <= chunk:
        mask = None
        if causal:
            mask = torch.ones((s, s), dtype=torch.bool,
                              device=q.device).tril()
        o, m, l = _chunk_attn_step(q, k, v, mask, softcap, scale)
        return o / _rows(l, o.dtype)

    if s % chunk:
        raise ValueError(f"blockwise attention over {s} positions needs a "
                         f"multiple of its chunk {chunk} (the reference "
                         f"asserts it)")
    n_chunks = s // chunk
    diag = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=q.device).tril()
    out = []
    for qi in range(n_chunks):
        q_blk = q[:, qi * chunk:(qi + 1) * chunk]
        acc = torch.zeros((b, chunk, h, hd), dtype=q.dtype, device=q.device)
        m_run = torch.full((b, h, chunk), NEG_INF, dtype=torch.float32,
                           device=q.device)
        l_run = torch.zeros((b, h, chunk), dtype=torch.float32,
                            device=q.device)
        for kj in range(qi + 1 if causal else n_chunks):
            sl = slice(kj * chunk, (kj + 1) * chunk)
            mask = diag if causal and kj == qi else None
            o, m, l = _chunk_attn_step(q_blk, k[:, sl], v[:, sl], mask,
                                       softcap, scale)
            m_new = torch.maximum(m_run, m)
            alpha = torch.exp(m_run - m_new)
            beta = torch.exp(m - m_new)
            l_run = l_run * alpha + l * beta
            acc = acc * _rows(alpha, acc.dtype) + o * _rows(beta, o.dtype)
            m_run = m_new
        out.append(acc / _rows(l_run, acc.dtype))
    return torch.cat(out, dim=1)


def _sliding_window_attention(q, k, v, *, window: int, softcap, scale):
    """Exact sliding-window causal attention: each window-sized block
    attends to itself (causal) and to the block before it (banded).  Block
    0 has no block before it; the reference's fully masked term there has
    weight exactly 0 and is skipped."""
    b, s, h, hd = q.shape
    blk = window
    if s % blk:
        raise ValueError(f"sliding-window attention over {s} positions "
                         f"needs a multiple of the window {blk} (the "
                         f"reference asserts it)")
    i = torch.arange(blk, device=q.device)
    diag_mask = i[:, None] >= i[None, :]
    # position q_i of a block attends k_j of the one before when
    # (q_i + blk - k_j) < window
    prev_mask = (i[:, None] + blk - i[None, :]) < window
    out = []
    for n in range(s // blk):
        cur = slice(n * blk, (n + 1) * blk)
        q_blk = q[:, cur]
        o1, m1, l1 = _chunk_attn_step(q_blk, k[:, cur], v[:, cur], diag_mask,
                                      softcap, scale)
        if n == 0:
            out.append(o1 / _rows(l1, o1.dtype))
            continue
        prev = slice((n - 1) * blk, n * blk)
        o2, m2, l2 = _chunk_attn_step(q_blk, k[:, prev], v[:, prev],
                                      prev_mask, softcap, scale)
        m = torch.maximum(m1, m2)
        a1, a2 = torch.exp(m1 - m), torch.exp(m2 - m)
        l = l1 * a1 + l2 * a2
        o = o1 * _rows(a1, o1.dtype) + o2 * _rows(a2, o2.dtype)
        out.append(o / _rows(l, o.dtype))
    return torch.cat(out, dim=1)


def uses_flash(s: int, window: int | None,
               attn_softcap: float | None) -> bool:
    """Whether ``mha`` over ``s`` positions computes the function of the
    flash kernel (no softcap, no window shorter than the sequence)."""
    return attn_softcap is None and (window is None or window >= s)


def _under_grad(*ts: torch.Tensor) -> bool:
    """Whether autograd records an op on ``ts``: grad mode on and one of
    them requiring grad.  The flash kernel has no backward (nor has the
    Pallas kernel), so a training forward takes the plain
    ``blockwise_attention``, the function the reference trains through."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def mha(p: dict, x: torch.Tensor, positions: torch.Tensor, *, n_heads: int,
        n_kv: int, head_dim: int, causal: bool = True,
        window: int | None = None, attn_softcap: float | None = None,
        rope_theta: float = 10000.0, chunk: int = 1024,
        use_rope: bool = True, return_kv: bool = False, plan=None,
        seq: bool = False):
    """Full-sequence attention layer, x (B, S, D); with ``return_kv`` also
    the roped, unrepeated (k, v), (B, S, n_kv, hd) each.  The flash kernel
    where ``uses_flash`` and autograd records nothing (a forward under
    ``torch.no_grad()``, or of tensors that require no grad), else
    ``blockwise_attention``.  With a ``plan`` (``nn.module.Plan``) whose
    tensor-parallel axis cuts the projections, ``p`` holds this rank's
    blocks and the heads split over the ranks (``_heads_tp``); with
    ``seq`` (sequence parallelism) x is this rank's block (B, S / tp, D)
    of the sequence, ``positions`` the whole sequence's, the sequence is
    gathered before the projections, and the output is this rank's block
    again (K/V whole over the sequence)."""
    if plan is not None and plan.tp is not None:
        return _mha_tp(p, x, positions, n_heads=n_heads, n_kv=n_kv,
                       head_dim=head_dim, causal=causal, window=window,
                       attn_softcap=attn_softcap, rope_theta=rope_theta,
                       chunk=chunk, use_rope=use_rope, return_kv=return_kv,
                       plan=plan, seq=seq)
    q = _split_heads(layers.linear(p["wq"], x), n_heads, head_dim)
    k = _split_heads(layers.linear(p["wk"], x), n_kv, head_dim)
    v = _split_heads(layers.linear(p["wv"], x), n_kv, head_dim)
    if use_rope:
        q = layers.rope(q, positions, rope_theta)
        k = layers.rope(k, positions, rope_theta)
    kv = (k, v)
    n_rep = n_heads // n_kv
    kr, vr = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    o = _core(q, kr, vr, causal, window, attn_softcap, chunk)
    b, s = x.shape[:2]
    out = layers.linear(p["wo"], o.reshape(b, s, n_heads * head_dim))
    if return_kv:
        return out, kv
    return out


def _core(q, kr, vr, causal, window, attn_softcap, chunk):
    """Attention of q / kr / vr (B, S, H, hd), kv head-repeated: the
    flash kernel on (B * H, S, hd) where it applies, else
    ``blockwise_attention``."""
    b, s, h, hd = q.shape
    if uses_flash(s, window, attn_softcap) and not _under_grad(q, kr, vr):
        o = flash_attention_fwd(_heads_first(q), _heads_first(kr),
                                _heads_first(vr), causal=causal)
        return o.reshape(b, h, s, hd).transpose(1, 2)
    return blockwise_attention(q, kr, vr, causal=causal, window=window,
                               softcap=attn_softcap, chunk=chunk)


def heads_local(n_heads: int, cols: int, head_dim: int, tp: int) -> bool:
    """Whether a projection of ``n_heads`` heads held as ``cols`` columns
    a rank (its block over the tensor-parallel axis of ``tp`` ranks)
    holds whole heads: the block is cut and the heads divide."""
    return cols != n_heads * head_dim and n_heads % tp == 0


def _heads_tp(p, x, n_heads, n_kv, head_dim, plan, seq=False):
    """The projections under tensor parallelism: (q (B, S, h1 - h0, hd)
    of heads [h0, h1), k, v (B, S, n_kv_l, hd) of kv heads [kv0, kv0 +
    n_kv_l), h0, h1, kv0, whether the heads are this rank's).

    Where the q projection's block holds whole heads (``heads_local``)
    the rank computes its heads; their kv heads are its own where those
    divide too, else the kv projection gathered whole over the axis
    (GSPMD's reshard: its backward sums the ranks' parts).  Where the
    block cuts a head (qwen2.5's 40 heads over 16) q and kv are gathered
    whole and every rank of the axis computes every head alike.

    With ``seq`` x is this rank's block of the sequence, gathered first:
    where every projection is cut, by ``gather_seq`` (the backward
    reduce-scatters the ranks' partial cotangents); where one runs whole
    on every rank, by ``gather_from``, the cut ones entering through
    ``copy_to`` as without ``seq``."""
    mesh, ax, tp, r = plan.mesh, plan.tp, plan.tp_size, plan.tp_index
    q_cut = p["wq"]["w"].shape[1] != n_heads * head_dim
    kv_cut = p["wk"]["w"].shape[1] != n_kv * head_dim
    mine = heads_local(n_heads, p["wq"]["w"].shape[1], head_dim, tp)
    kv_mine = mine and heads_local(n_kv, p["wk"]["w"].shape[1], head_dim,
                                   tp)
    if seq and q_cut and kv_cut:
        x = xin = collectives.gather_seq(x, mesh, ax)
    else:
        if seq:
            x = collectives.gather_from(x, mesh, ax, 1)
        xin = collectives.copy_to(x, mesh, ax)
    q = layers.linear(p["wq"], xin if q_cut else x)
    k = layers.linear(p["wk"], xin if kv_cut else x)
    v = layers.linear(p["wv"], xin if kv_cut else x)
    if q_cut and not mine:
        q = collectives.gather_from(q, mesh, ax, -1)
    if kv_cut and not kv_mine:
        gather = collectives.all_gather if mine else collectives.gather_from
        k, v = gather(k, mesh, ax, -1), gather(v, mesh, ax, -1)
    elif not kv_cut and mine:
        # the same k / v on every rank, each rank using its heads' part
        k = collectives.copy_to(k, mesh, ax)
        v = collectives.copy_to(v, mesh, ax)
    h = n_heads // tp if mine else n_heads
    h0 = r * h if mine else 0
    n_kv_l = n_kv // tp if kv_mine else n_kv
    kv0 = r * n_kv_l if kv_mine else 0
    return (_split_heads(q, h, head_dim), _split_heads(k, n_kv_l, head_dim),
            _split_heads(v, n_kv_l, head_dim), h0, h0 + h, kv0, mine)


def _kv_for(k, h0, h1, kv0, n_rep):
    """The kv heads of q heads [h0, h1), repeated to one a q head."""
    a, b = h0 // n_rep, (h1 - 1) // n_rep + 1
    k = _repeat_kv(k[..., a - kv0:b - kv0, :], n_rep)
    return k[..., h0 - a * n_rep:h1 - a * n_rep, :]


def out_proj(p: dict, o: torch.Tensor, n_heads: int, head_dim: int,
             mine: bool, plan, seq: bool = False) -> torch.Tensor:
    """``wo`` on o (B, S, h * hd): this rank's heads (``mine``) or every
    head alike on each rank.  A cut ``wo`` takes this rank's block of
    its rows, the products summed over the axis.  With ``seq`` the
    result is this rank's block of the sequence: the sum
    reduce-scattered along it, or a whole ``wo``'s output cut
    (``split_to``)."""
    mesh, ax = plan.mesh, plan.tp
    if p["w"].shape[0] == n_heads * head_dim:
        if mine:
            o = collectives.gather_from(o, mesh, ax, -1)
        y = layers.linear(p, o)
        return collectives.split_to(y, mesh, ax, 1) if seq else y
    if not mine:
        o = collectives.split_to(o, mesh, ax, -1)
    return layers.row_linear(p, o, mesh, ax, seq)


def _mha_tp(p, x, positions, *, n_heads, n_kv, head_dim, causal, window,
            attn_softcap, rope_theta, chunk, use_rope, return_kv, plan,
            seq=False):
    q, k, v, h0, h1, kv0, mine = _heads_tp(p, x, n_heads, n_kv, head_dim,
                                           plan, seq)
    if use_rope:
        q = layers.rope(q, positions, rope_theta)
        k = layers.rope(k, positions, rope_theta)
    n_rep = n_heads // n_kv
    o = _core(q, _kv_for(k, h0, h1, kv0, n_rep), _kv_for(v, h0, h1, kv0,
                                                         n_rep),
              causal, window, attn_softcap, chunk)
    b, s = q.shape[:2]
    out = out_proj(p["wo"], o.reshape(b, s, (h1 - h0) * head_dim), n_heads,
                   head_dim, mine, plan, seq)
    if return_kv:
        # the cache holds every kv head (``cache_heads`` is whole)
        if k.shape[-2] != n_kv:
            k = collectives.gather_from(k, plan.mesh, plan.tp, -2)
            v = collectives.gather_from(v, plan.mesh, plan.tp, -2)
        return out, (k, v)
    return out


def prefill_cache_from_kv(k: torch.Tensor, v: torch.Tensor,
                          window: int | None = None) -> dict:
    """Prefill-computed (roped) K/V as the decode cache.

    Global layers, and local ones whose window spans the prompt: (k, v)
    itself.  Local layers over a longer prompt: the last ``window``
    positions in ring-buffer order (slot = pos % window) with their
    absolute positions, ``slot_pos`` (B, window) int32, as the ring decode
    reads them."""
    s = k.shape[1]
    if window is None or window >= s:
        return {"k": k, "v": v}
    pos = torch.arange(s - window, s, device=k.device)
    inv = torch.argsort(pos % window)
    slot_pos = pos[inv].to(torch.int32).expand(k.shape[0], window)
    return {"k": k[:, s - window:][:, inv], "v": v[:, s - window:][:, inv],
            "slot_pos": slot_pos.contiguous()}


def write_rows(buf: torch.Tensor, slot: torch.Tensor, new: torch.Tensor,
               keep: torch.Tensor | None = None) -> None:
    """``buf`` (B, S, ...) with row i's slot ``slot[i]`` set to ``new[i]``
    (B, ...), in place: the values of the reference's one-hot update
    (every other slot times 1 plus 0, the written one times 0 plus the new
    value) without a second copy of the buffer.  Where ``keep`` (B,) is
    set, the slot keeps its value (the reference's all-zero one-hot row).
    ``buf`` is written through a flat view, so it must be contiguous."""
    b, s_max = buf.shape[:2]
    flat = buf.view(b * s_max, *buf.shape[2:])
    idx = slot + torch.arange(0, b * s_max, s_max, device=buf.device)
    new = new.to(buf.dtype)
    if keep is not None:
        keep = keep.view(-1, *([1] * (new.dim() - 1)))
        new = torch.where(keep, flat.index_select(0, idx), new)
    flat.index_copy_(0, idx, new)


def _write_at_pos(bufs, news, pos: torch.Tensor, s_max: int,
                  first: int = 0) -> None:
    """Each (buf, new (B, 1, ...)) written at row i's ``pos[i]``.  A row at
    or past ``s_max`` has an all-zero one-hot row in the reference, so its
    buffers keep their values: the write goes to the last slot and puts
    its old value back, which needs no host sync on ``pos`` and indexes
    nothing out of bounds.  ``bufs`` may hold a rank's block of the
    slots, those from ``first`` on: a row whose slot lies outside it
    keeps the block as it is."""
    n = bufs[0].shape[1]
    at = pos - first
    keep = (pos >= s_max) | (at < 0) | (at >= n)
    slot = torch.clamp(at, 0, n - 1)
    for buf, new in zip(bufs, news):
        write_rows(buf, slot, new[:, 0], keep)


def _attend(q, kk, vv, valid, head_dim, attn_softcap, n_rep, plan=None):
    """One query against a cache: q (B, 1, H, hd), kk / vv (B, S, n_kv,
    hd), valid (B, S) -> (B, 1, H, hd) in vv's dtype.  With a ``plan``
    the cache is this rank's block of the slots over its tensor-parallel
    axis (split-KV): the row max, the sum of the weights and the
    weighted values are combined over the axis.  A block with no valid
    slot has the max -1e30, and its weights vanish in the combine."""
    kk, vv = _repeat_kv(kk, n_rep), _repeat_kv(vv, n_rep)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk.to(q.dtype)).float()
    s = s / (head_dim ** 0.5)
    s = layers.softcap(s, attn_softcap)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    if plan is None:
        w = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", w.to(vv.dtype), vv)
    mesh, ax = plan.mesh, plan.tp
    m = collectives.pmax(torch.amax(s, dim=-1, keepdim=True), mesh, ax)
    e = torch.exp(s - m)
    l = collectives.reduce_from(torch.sum(e, dim=-1, keepdim=True), mesh,
                                ax)
    o = torch.einsum("bhqk,bkhd->bqhd", (e / l).to(vv.dtype), vv)
    return collectives.reduce_from(o, mesh, ax)


def _qkv_decode(p, x, pos, n_heads, n_kv, head_dim, rope_theta, use_rope,
                plan=None):
    """q, k_new, v_new (B, 1, heads, hd), every head; with a ``plan`` the
    projections' blocks gathered over its tensor-parallel axis."""
    q = layers.linear(p["wq"], x)
    k_new = layers.linear(p["wk"], x)
    v_new = layers.linear(p["wv"], x)
    if plan is not None and plan.tp is not None:
        q, k_new, v_new = (
            collectives.gather_from(t, plan.mesh, plan.tp, -1)
            if t.shape[-1] != n * head_dim else t
            for t, n in ((q, n_heads), (k_new, n_kv), (v_new, n_kv)))
    q = _split_heads(q, n_heads, head_dim)
    k_new = _split_heads(k_new, n_kv, head_dim)
    v_new = _split_heads(v_new, n_kv, head_dim)
    if use_rope:
        q = layers.rope(q, pos[:, None], rope_theta)
        k_new = layers.rope(k_new, pos[:, None], rope_theta)
    return q, k_new, v_new


def slot_block(n_local: int, n_global: int, plan) -> tuple[int, object]:
    """(the first slot of this rank's block of a cache's ``n_global``
    slots held as ``n_local``, the plan to combine over, ``None`` where
    the block is the whole cache)."""
    if plan is None or plan.tp is None or n_local == n_global:
        return 0, None
    return plan.tp_index * n_local, plan


def _wo(p, o, n_heads, head_dim, plan):
    b = o.shape[0]
    o = o.reshape(b, 1, n_heads * head_dim)
    if plan is None or plan.tp is None:
        return layers.linear(p, o)
    return out_proj(p, o, n_heads, head_dim, False, plan)


def _cache_len(plan, s_local: int) -> int:
    if plan is None or plan.tp is None:
        return s_local
    if plan.cache_len is None:
        raise ValueError("a decode step under tensor parallelism needs the "
                         "cache's global slot count (nn.module.plan(..., "
                         "cache_len=))")
    return plan.cache_len


def mha_decode_quant(p: dict, x: torch.Tensor, cache: dict,
                     pos: torch.Tensor, *, n_heads: int, n_kv: int,
                     head_dim: int, kv_quant: str,
                     attn_softcap: float | None = None,
                     rope_theta: float = 10000.0,
                     plan=None) -> tuple[torch.Tensor, dict]:
    """Decode against a quantized KV cache (int8 / int4): payload and a
    per-(position, head) scale are stored, and K/V dequantize to bf16
    right before the attention products, as in the reference (whose
    output is then bf16 whatever the config's dtype).  The new payload
    and scales are written into ``cache`` in place.  ``plan`` as in
    ``mha_decode``."""
    s_loc = cache["k"].shape[1]
    s_max = _cache_len(plan, s_loc)
    first, split = slot_block(s_loc, s_max, plan)
    q, k_new, v_new = _qkv_decode(p, x, pos, n_heads, n_kv, head_dim,
                                  rope_theta, True, plan)
    kq, ks = kvq.quantize(k_new, kv_quant)       # (B,1,G,hs), (B,1,G,1)
    vq, vs = kvq.quantize(v_new, kv_quant)
    _write_at_pos([cache[key] for key in ("k", "v", "k_scale", "v_scale")],
                  [kq, vq, ks, vs], pos, s_max, first)
    kk = kvq.dequantize(cache["k"], cache["k_scale"], kv_quant)
    vv = kvq.dequantize(cache["v"], cache["v_scale"], kv_quant)
    span = first + torch.arange(s_loc, device=x.device)
    valid = span[None, :] <= pos[:, None]
    o = _attend(q, kk, vv, valid, head_dim, attn_softcap, n_heads // n_kv,
                split)
    return _wo(p["wo"], o, n_heads, head_dim, plan), cache


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_max, n_kv, hd)
    v: torch.Tensor          # (B, S_max, n_kv, hd)


def mha_decode(p: dict, x: torch.Tensor, cache: KVCache, pos: torch.Tensor,
               *, n_heads: int, n_kv: int, head_dim: int,
               window: int | None = None,
               attn_softcap: float | None = None,
               rope_theta: float = 10000.0,
               use_rope: bool = True,
               plan=None) -> tuple[torch.Tensor, KVCache]:
    """x (B, 1, D); pos (B,) the current length.  Returns (out, cache).

    The new K/V are written into ``cache`` in place at each row's
    position (``write_rows``); a row at or past ``s_max`` writes nothing
    and sees every slot, as in the reference.  With ``window`` a row sees
    the slots of its last ``window`` positions only.  With a ``plan``
    (``nn.module.Plan``) ``p`` holds this rank's blocks, every head is
    computed on each rank, and ``cache`` may be this rank's block of the
    slots (``cache_seq`` over the tensor-parallel axis, of
    ``plan.cache_len`` in all): the rank writes the rows whose position
    falls in its block and the attention is split-KV (``_attend``)."""
    s_loc = cache.k.shape[1]
    s_max = _cache_len(plan, s_loc)
    first, split = slot_block(s_loc, s_max, plan)
    q, k_new, v_new = _qkv_decode(p, x, pos, n_heads, n_kv, head_dim,
                                  rope_theta, use_rope, plan)
    _write_at_pos([cache.k, cache.v], [k_new, v_new], pos, s_max, first)
    span = first + torch.arange(s_loc, device=x.device)
    valid = span[None, :] <= pos[:, None]                     # causal fill
    if window is not None:
        valid = valid & (span[None, :] > pos[:, None] - window)
    o = _attend(q, cache.k, cache.v, valid, head_dim, attn_softcap,
                n_heads // n_kv, split)
    return _wo(p["wo"], o, n_heads, head_dim, plan), cache
