"""The MoE router and the dense-combine experts (``repro_torch.nn.moe``)
against the JAX package's on the CPU.

Operands come from ``numpy.random.RandomState``; the rescue's Gumbel
sample is drawn by ``jax.random.gumbel`` and passed across.  Everything
is f32.  The router's selected indices are held exactly, its gates and
probabilities within 1e-6 (``jax.nn.softmax`` and ``torch.softmax`` may
round an ``exp`` or the row sum an ULP apart); the experts, the aux loss
and ``moe_ref`` within rtol = atol = 1e-5, as ``test_torch_lm.py``
states for f32 sums taken in another order.

Ties: ``jax.lax.top_k`` puts the lower index first among equal values,
and the port's stable descending sort does the same, where
``torch.topk`` promises no order.  Rows of exact ties pin it, and rows
of logits one ULP apart show which expert wins a near tie on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import moe as j_moe
from repro_torch.nn import moe as t_moe

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
GATE_TOL = dict(rtol=1e-6, atol=1e-6)


def _router_both(logits: np.ndarray, k: int, **kw):
    want = j_moe.router_topk(jnp.asarray(logits), k, **kw)
    if "rng" in kw:
        gumbel = np.array(jax.random.gumbel(kw.pop("rng"), logits.shape))
        kw["gumbel"] = torch.from_numpy(gumbel)
    got = t_moe.router_topk(torch.from_numpy(logits), k, **kw)
    return got, want


def _assert_router(got, want):
    (g_gate, g_idx, g_probs), (w_gate, w_idx, w_probs) = got, want
    np.testing.assert_array_equal(g_idx.numpy(), np.asarray(w_idx))
    np.testing.assert_allclose(g_gate.numpy(), np.asarray(w_gate),
                               **GATE_TOL)
    np.testing.assert_allclose(g_probs.numpy(), np.asarray(w_probs),
                               **GATE_TOL)


@pytest.mark.parametrize("shape,k", [((3, 17, 8), 2), ((5, 384), 8),
                                     ((64, 128), 2), ((2, 9, 16), 1)],
                         ids=str)
def test_router_topk_matches_reference(shape, k):
    logits = np.random.RandomState(sum(shape)).randn(*shape).astype(
        np.float32)
    got, want = _router_both(logits, k)
    _assert_router(got, want)
    assert got[1].dtype == torch.int64 and tuple(got[1].shape) == \
        shape[:-1] + (k,)


def test_router_topk_exact_ties_lower_index_first():
    """Rows of exact ties: all equal, a tie across the k-th place, a tie
    inside the winners, and ties among bf16-rounded logits (the router's
    dtype at full width): the indices are the reference's, the lower
    index first."""
    rows = np.array([
        [0.5] * 8,
        [1.0, 2.0, 2.0, 0.0, 2.0, -1.0, 0.0, 2.0],
        [3.0, 1.0, 3.0, 1.0, 1.0, 0.0, 1.0, 0.0],
        [-1.0, -1.0, 0.0, 0.0, -1.0, 0.0, -1.0, 0.0],
    ], np.float32)
    for k in (1, 2, 3, 5):
        got, want = _router_both(rows, k)
        _assert_router(got, want)
    idx = t_moe.router_topk(torch.from_numpy(rows), 3)[1].tolist()
    assert idx[0] == [0, 1, 2] and idx[1] == [1, 2, 4]
    assert idx[2] == [0, 2, 1] and idx[3] == [2, 3, 5]
    coarse = np.random.RandomState(3).randn(64, 384).astype(np.float32)
    coarse = np.asarray(jnp.asarray(coarse).astype(jnp.bfloat16)
                        .astype(jnp.float32)) * 0.1
    assert (np.sort(coarse, -1)[:, 1:] == np.sort(coarse, -1)[:, :-1]).any()
    got, want = _router_both(coarse, 8)
    _assert_router(got, want)


def _winner(probs: np.ndarray, a: int, b: int) -> int:
    """Which of experts a < b a top-k takes first: the larger probability,
    the lower index on a tie."""
    return b if probs[b] > probs[a] else a


def test_router_topk_near_tie_one_ulp_apart():
    """Logits one ULP apart: ``jnp.exp`` (XLA) and ``torch.exp`` round
    some values an ULP apart (186 of 2048 here), so at such a near tie
    one package may see two equal probabilities (the lower index wins)
    where the other sees them an ULP apart (the larger wins).  Each
    package's pick follows its own probabilities by that rule in every
    row; the indices are equal wherever the two packages' probabilities
    of the pair compare alike; where they part, the pair's probabilities
    are within one ULP on both sides."""
    rs = np.random.RandomState(5)
    rows = rs.randn(256, 8).astype(np.float32)
    a = rs.randint(0, 7, 256)
    b = a + 1 + (rs.rand(256) * (7 - a)).astype(int)
    lead = rows.max(-1) + np.float32(0.5)        # the pair leads its row
    rows[np.arange(256), a] = lead
    rows[np.arange(256), b] = np.nextafter(lead, np.float32(np.inf))
    (_, g_idx, g_probs), (_, w_idx, w_probs) = _router_both(rows, 1)
    g_idx, g_probs = g_idx.numpy()[:, 0], g_probs.numpy()
    w_idx, w_probs = np.asarray(w_idx)[:, 0], np.asarray(w_probs)
    parted = 0
    for r in range(256):
        assert g_idx[r] == _winner(g_probs[r], a[r], b[r]), r
        assert w_idx[r] == _winner(w_probs[r], a[r], b[r]), r
        alike = np.sign(g_probs[r, b[r]] - g_probs[r, a[r]]) == \
            np.sign(w_probs[r, b[r]] - w_probs[r, a[r]])
        if alike:
            assert g_idx[r] == w_idx[r], r
        else:
            parted += 1
            for probs in (g_probs[r], w_probs[r]):
                assert abs(int(probs[a[r]].view(np.int32))
                           - int(probs[b[r]].view(np.int32))) <= 1, r
    assert parted < 256 // 4
    np.testing.assert_allclose(g_probs, w_probs, **GATE_TOL)


@pytest.mark.parametrize("snl", [0.02, 0.3])
def test_router_snl_rescue_with_the_reference_draw(snl):
    logits = np.random.RandomState(7).randn(4, 33, 16).astype(np.float32)
    got, want = _router_both(logits, 3, snl_rescue=snl,
                             rng=jax.random.PRNGKey(11))
    _assert_router(got, want)
    plain = t_moe.router_topk(torch.from_numpy(logits), 3)
    assert not torch.equal(plain[2], got[2])


def _experts(rs, e, d, f):
    return [(rs.randn(*shape) / np.sqrt(shape[-2])).astype(np.float32)
            for shape in ((e, d, f), (e, d, f), (e, f, d))]


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_expert_ffn_matches_reference(activation):
    rs = np.random.RandomState(13)
    ws = _experts(rs, 6, 24, 40)
    x = rs.randn(6, 9, 24).astype(np.float32)
    want = j_moe._expert_ffn(*map(jnp.asarray, ws), jnp.asarray(x),
                             activation)
    got = t_moe._expert_ffn(*map(torch.from_numpy, ws), torch.from_numpy(x),
                            activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_aux_load_balance_loss_matches_reference():
    rs = np.random.RandomState(17)
    logits = rs.randn(3, 21, 8).astype(np.float32)
    _, w_idx, w_probs = j_moe.router_topk(jnp.asarray(logits), 2)
    want = j_moe.aux_load_balance_loss(w_probs, w_idx, 8, 2)
    got = t_moe.aux_load_balance_loss(torch.from_numpy(np.array(w_probs)),
                                      torch.from_numpy(np.array(w_idx))
                                      .long(), 8, 2)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _moe_params(rs, e, d, f):
    w_in, w_gate, w_out = _experts(rs, e, d, f)
    return {"router": (rs.randn(d, e) * 0.3).astype(np.float32),
            "w_in": w_in, "w_gate": w_gate, "w_out": w_out}


@pytest.mark.parametrize("chunk", [None, 1, 3 * 14 * 24],
                         ids=["one_chunk", "one_expert_a_chunk",
                              "three_experts_a_chunk"])
@pytest.mark.parametrize("e,k", [(8, 2), (16, 8)], ids=str)
def test_moe_ref_matches_reference(e, k, chunk, monkeypatch):
    """The dense combine over every expert, the output and the aux loss;
    also with the experts run in chunks (one expert a chunk, and three);
    without the aux loss (a decode step's) the same output."""
    if chunk is not None:
        monkeypatch.setattr(t_moe, "CHUNK_ELEMENTS", chunk)
    rs = np.random.RandomState(19 + e)
    p = _moe_params(rs, e, 16, 24)
    x = rs.randn(2, 7, 16).astype(np.float32)
    want, w_aux = j_moe.moe_ref(jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x), k=k)
    got, g_aux = t_moe.moe_ref(jax.tree.map(torch.from_numpy, p),
                               torch.from_numpy(x), k=k)
    n_chunks = len(t_moe.expert_chunks(e, 14, 24))
    assert n_chunks == {None: 1, 1: e, 3 * 14 * 24: -(-e // 3)}[chunk]
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(g_aux.numpy(), np.asarray(w_aux), **TOL)
    bare, none = t_moe.moe_ref(jax.tree.map(torch.from_numpy, p),
                               torch.from_numpy(x), k=k, with_aux=False)
    assert none is None and torch.equal(bare, got)


def test_moe_specs_equal_reference():
    j = j_moe.moe_specs(56, 40, 12)
    t = t_moe.moe_specs(56, 40, 12)
    assert set(j) == set(t)
    for name in j:
        assert t[name].shape == j[name].shape
        assert t[name].axes == j[name].axes
        assert t[name].scale == j[name].scale and t[name].init == \
            j[name].init
