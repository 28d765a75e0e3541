"""The quantized KV cache and the attention pieces of the local/global and
softcapped configurations, against the JAX package on the CPU.

``nn.kvq`` bit for bit (int8 and int4, half-way ties, all-zero rows);
``mha_decode_quant`` bit for bit on the same operands (the quantization,
the in-place writes, the bf16 products); ``blockwise_attention`` with a
window and a softcap at rtol = atol = 1e-5 in f32 (the two sides round
the same f32 operations in another order); ``prefill_cache_from_kv``'s
ring order exactly; ``mha_decode``'s window mask at 1e-5.  Where the
reference asserts that the sequence divides into windows or chunks, the
port raises ``ValueError``.  Operands come from
``numpy.random.RandomState``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as j_attention
from repro.nn import kvq as j_kvq
from repro_torch.nn import attention as t_attention
from repro_torch.nn import kvq as t_kvq

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
MODES = ("int8", "int4")


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


# --- kvq ------------------------------------------------------------------------

def _kv_rows(rs, mode):
    """(B, S, G, hd) rows: random, one all-zero row, and rows whose max
    makes the scale exactly 1 with values on half-way points (ties)."""
    x = rs.randn(2, 5, 3, 16).astype(np.float32) * 2.0
    qmax = 127.0 if mode == "int8" else 7.0
    x[0, 0, 0] = 0.0
    ties = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 3.5, -3.5, 4.5,
                     -4.5, 5.5, -5.5, 6.5, -6.5, qmax, -qmax], np.float32)
    x[0, 1, 0] = ties
    x[1, 2, 1] = ties[::-1]
    return x


@pytest.mark.parametrize("mode", MODES)
def test_kvq_quantize_dequantize_bit_for_bit(mode):
    x = _kv_rows(np.random.RandomState(0), mode)
    jq, js = j_kvq.quantize(jnp.asarray(x), mode)
    tq, ts = t_kvq.quantize(torch.from_numpy(x), mode)
    _same(tq, jq)
    _same(ts, js)
    assert tq.dtype == t_kvq.storage_dtype(mode)
    assert tq.shape[-1] == t_kvq.storage_shape(16, mode)
    # half-way points round to even on both sides
    if mode == "int8":
        np.testing.assert_array_equal(tq[0, 1, 0, :14].numpy(),
                                      [0, 0, 2, -2, 2, -2, 4, -4, 4, -4,
                                       6, -6, 6, -6])
    # an all-zero row: codes 0 (int4: both nibbles 0 + 8), scale 1e-8 / Q
    assert (tq[0, 0, 0] == (0 if mode == "int8" else 0x88)).all()
    for dtype, jdt in ((torch.bfloat16, jnp.bfloat16),
                       (torch.float32, jnp.float32)):
        want = j_kvq.dequantize(jq, js, mode, jdt).astype(jnp.float32)
        got = t_kvq.dequantize(tq, ts, mode, dtype)
        assert got.dtype == dtype
        _same(got.float(), want)


def test_kvq_bf16_input_and_unknown_mode():
    x = np.random.RandomState(1).randn(3, 4, 32).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    for mode in MODES:
        jq, js = j_kvq.quantize(jx, mode)
        tq, ts = t_kvq.quantize(tx, mode)
        _same(tq, jq)
        _same(ts, js)
    with pytest.raises(ValueError):
        t_kvq.quantize(tx, "int2")
    with pytest.raises(ValueError):
        t_kvq.dequantize(torch.zeros(2, dtype=torch.int8),
                         torch.ones(1), "fp8")


# --- blockwise attention ----------------------------------------------------------

def _qkv(rs, b, s, h, hd):
    return [rs.randn(b, s, h, hd).astype(np.float32) for _ in range(3)]


BLOCKWISE_CASES = [
    # (S, window, softcap, chunk, causal)
    (48, None, None, 64, True),          # one chunk
    (48, None, 5.0, 64, True),
    (48, None, 5.0, 64, False),
    (128, None, 5.0, 32, True),          # four chunks, online softmax
    (128, None, None, 32, False),
    (64, 16, None, 1024, True),          # sliding window, four blocks
    (64, 16, 5.0, 1024, True),
    (96, 32, 50.0, 16, True),            # window wins over the chunk
    (32, 32, 5.0, 16, True),             # window spans S: chunked path
    (24, 64, None, 64, True),            # window longer than S
]


@pytest.mark.parametrize("case", BLOCKWISE_CASES, ids=str)
def test_blockwise_attention_matches_reference(case):
    s, window, softcap, chunk, causal = case
    q, k, v = _qkv(np.random.RandomState(s + (window or 0)), 2, s, 3, 16)
    kw = dict(causal=causal, window=window, softcap=softcap, chunk=chunk)
    want = j_attention.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                           **kw)
    got = t_attention.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                          **kw)
    _close(got, want)


def test_blockwise_attention_bf16_matches_reference():
    """bf16 in and out: both sides round the scores' products and the
    probabilities to bf16 at the same places but sum in other orders, so
    the outputs (|o| < 2) agree within about one bf16 ULP (2^-8 relative,
    0.0078 at 2), hence 1e-2."""
    q, k, v = _qkv(np.random.RandomState(3), 1, 64, 2, 16)
    kw = dict(causal=True, window=16, softcap=50.0)
    want = j_attention.blockwise_attention(
        *(jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)), **kw)
    got = t_attention.blockwise_attention(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)), **kw)
    assert got.dtype == torch.bfloat16
    _close(got, want.astype(jnp.float32), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("s, window, chunk", [(40, 16, 1024), (100, None, 32)])
def test_sequence_not_a_multiple_raises_in_both(s, window, chunk):
    q, k, v = _qkv(np.random.RandomState(4), 1, s, 2, 8)
    kw = dict(window=window, softcap=5.0, chunk=chunk)
    with pytest.raises(AssertionError):
        j_attention.blockwise_attention(*map(jnp.asarray, (q, k, v)), **kw)
    with pytest.raises(ValueError, match="multiple"):
        t_attention.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                        **kw)


def _attn_params(rs, d, n_heads, n_kv, hd):
    p = {name: {"w": (rs.randn(d, n * hd) / np.sqrt(d)).astype(np.float32)}
         for name, n in (("wq", n_heads), ("wk", n_kv), ("wv", n_kv))}
    p["wo"] = {"w": (rs.randn(n_heads * hd, d) / np.sqrt(d))
               .astype(np.float32)}
    return p


@pytest.mark.parametrize("window, softcap", [(None, None), (16, None),
                                             (64, 5.0), (None, 50.0),
                                             (16, 50.0)])
def test_mha_routes_and_matches_reference(window, softcap):
    """The flash kernel's plain version where ``uses_flash`` holds, the
    blockwise path elsewhere; both against the reference's ``mha``."""
    rs = np.random.RandomState(5)
    d, h, g, hd, s = 32, 4, 2, 8, 64
    p = _attn_params(rs, d, h, g, hd)
    x = rs.randn(2, s, d).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (2, s))
    kw = dict(n_heads=h, n_kv=g, head_dim=hd, window=window,
              attn_softcap=softcap, chunk=32, return_kv=True)
    want, (wk, wv) = j_attention.mha(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x), jnp.asarray(pos), **kw)
    got, (gk, gv) = t_attention.mha(jax.tree.map(torch.from_numpy, p),
                                    torch.from_numpy(x),
                                    torch.from_numpy(pos.copy()), **kw)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)
    assert t_attention.uses_flash(s, window, softcap) == (
        softcap is None and (window is None or window >= s))


@pytest.mark.parametrize("s, window", [(64, 16), (40, 8), (16, 16), (9, 32)])
def test_prefill_cache_ring_order_matches_reference(s, window):
    rs = np.random.RandomState(s)
    k, v = (rs.randn(2, s, 1, 4).astype(np.float32) for _ in range(2))
    want = j_attention.prefill_cache_from_kv(jnp.asarray(k), jnp.asarray(v),
                                             window)
    got = t_attention.prefill_cache_from_kv(torch.from_numpy(k),
                                            torch.from_numpy(v), window)
    assert set(got) == set(want)
    for key in want:
        _same(got[key], want[key])
    if "slot_pos" in got:
        assert bool((got["slot_pos"] % window
                     == torch.arange(window)).all())


# --- decode ---------------------------------------------------------------------

def test_mha_decode_window_mask_matches_reference():
    rs = np.random.RandomState(6)
    d, h, g, hd, s_max = 32, 4, 2, 8, 24
    p = _attn_params(rs, d, h, g, hd)
    x = rs.randn(3, 1, d).astype(np.float32)
    k, v = (rs.randn(3, s_max, g, hd).astype(np.float32) for _ in range(2))
    pos = np.array([3, 17, 23], np.int32)
    kw = dict(n_heads=h, n_kv=g, head_dim=hd, window=6, attn_softcap=5.0)
    want, jc = j_attention.mha_decode(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        j_attention.KVCache(jnp.asarray(k), jnp.asarray(v)),
        jnp.asarray(pos), **kw)
    got, tc = t_attention.mha_decode(
        jax.tree.map(torch.from_numpy, p), torch.from_numpy(x),
        t_attention.KVCache(torch.from_numpy(k.copy()),
                            torch.from_numpy(v.copy())),
        torch.from_numpy(pos).long(), **kw)
    _close(got, want)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)


@pytest.mark.parametrize("mode", MODES)
def test_mha_decode_quant_bit_for_bit(mode):
    """The same payload, scales and operands on both sides: the output
    (bf16, as the reference's dequantized products give it) and the
    written cache equal the reference's bit for bit, a row past s_max
    writing nothing."""
    rs = np.random.RandomState(7)
    d, h, g, hd, s_max = 32, 4, 2, 16, 12
    p = _attn_params(rs, d, h, g, hd)
    x = rs.randn(3, 1, d).astype(np.float32)
    kq, ks = j_kvq.quantize(jnp.asarray(rs.randn(3, s_max, g, hd)
                                        .astype(np.float32)), mode)
    vq, vs = j_kvq.quantize(jnp.asarray(rs.randn(3, s_max, g, hd)
                                        .astype(np.float32)), mode)
    cache = {key: np.asarray(a) for key, a in
             (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))}
    pos = np.array([0, 7, s_max], np.int32)
    kw = dict(n_heads=h, n_kv=g, head_dim=hd, kv_quant=mode,
              attn_softcap=50.0)
    want, jc = j_attention.mha_decode_quant(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        jax.tree.map(jnp.asarray, cache), jnp.asarray(pos), **kw)
    tcache = {key: torch.from_numpy(a.copy()) for key, a in cache.items()}
    got, tc = t_attention.mha_decode_quant(
        jax.tree.map(torch.from_numpy, p), torch.from_numpy(x), tcache,
        torch.from_numpy(pos).long(), **kw)
    assert tc is tcache
    _same(got.float(), want.astype(jnp.float32))
    for key in cache:
        _same(tc[key], jc[key])
    for key in cache:                       # the row past s_max is as it was
        np.testing.assert_array_equal(tc[key][2].numpy(), cache[key][2])
