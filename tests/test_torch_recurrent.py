"""The recurrent cells (mLSTM, sLSTM, RG-LRU) against the JAX package on
the CPU: forward, final state and decode step.

Parameters come from the reference's ``materialize`` and cross over as
numpy arrays (``convert.lm_params_from_jax``); inputs come from
``numpy.random.RandomState``.  Everything is f32 and held at rtol = atol
= 1e-5: the two sides round the same operations in another order (the
projections' matmul sums, the RG-LRU's scan, whose products the port
takes by doubling and the reference by ``associative_scan``).

The mLSTM is the exception, and it is measured, not assumed: its output
divides by a normaliser that cancels (the sum of q.k terms of both
signs), so the reference itself moves by up to ~2e-4 at S = 512 when its
input moves by one ULP.  Its chunk arithmetic is held at 1e-5 on the same
projected operands (``_mlstm_chunk`` chained over the chunks, which is
the reference's ``lax.scan``), and the whole forward within four times
the reference's own change under a one-ULP perturbation of the input
(and never looser than 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import module as j_module
from repro.nn import recurrent as j_rec
from repro_torch.convert import lm_params_from_jax
from repro_torch.nn import recurrent as t_rec

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
D, H = 64, 4


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


def _params(specs, seed=1):
    jp = jax.tree.map(np.asarray, j_module.materialize(
        specs, jax.random.PRNGKey(seed)))
    return jax.tree.map(jnp.asarray, jp), lm_params_from_jax(jp, device="cpu")


def _x(rs, b, s, d=D):
    return rs.randn(b, s, d).astype(np.float32)


def _state(st) -> list[torch.Tensor]:
    return [torch.from_numpy(np.array(t)) for t in st]


def _one_ulp(rs, x: np.ndarray) -> np.ndarray:
    return np.nextafter(x, np.where(rs.rand(*x.shape) < 0.5, np.inf, -np.inf)
                        .astype(np.float32))


# --- mLSTM -----------------------------------------------------------------------

@pytest.mark.parametrize("s", [48, 256, 512])
def test_mlstm_chunks_match_reference_on_the_same_operands(s):
    """The chunkwise cell over S < 256, = 256 and two chunks, from the
    same q, k, v and gates: the outputs and the state at 1e-5."""
    rs = np.random.RandomState(s)
    hd, w = D // H, min(256, s)
    q, k, v = (rs.randn(2, s, H, hd).astype(np.float32) for _ in range(3))
    log_f = np.array(jax.nn.log_sigmoid(jnp.asarray(
        rs.randn(2, s, H).astype(np.float32) * 2)))
    log_i = rs.randn(2, s, H).astype(np.float32)
    jst = j_rec.mlstm_init_state(2, H, hd)
    tst = t_rec.MLSTMState(*_state(jst))
    for c0 in range(0, s, w):
        sl = slice(c0, c0 + w)
        ops = [a[:, sl] for a in (q, k, v, log_f, log_i)]
        jh, jst = j_rec._mlstm_chunk(*map(jnp.asarray, ops), jst)
        th, tst = t_rec._mlstm_chunk(*map(torch.from_numpy, ops), tst)
        _close(th, jh)
    for got, want in zip(tst, jst):
        _close(got, want)


def test_mlstm_cumsum_is_the_references_sum_order():
    rs = np.random.RandomState(0)
    for n in (1, 16, 17, 64, 256, 300):
        x = -np.abs(rs.randn(3, n, 4)).astype(np.float32)
        np.testing.assert_array_equal(
            t_rec._cumsum(torch.from_numpy(x)).numpy(),
            np.asarray(jnp.cumsum(jnp.asarray(x), axis=1)))


@pytest.mark.parametrize("s", [48, 256, 512])
def test_mlstm_forward_within_the_references_own_rounding(s):
    rs = np.random.RandomState(10 + s)
    jp, tp = _params(j_rec.mlstm_specs(D, H))
    x = _x(rs, 2, s)
    want, jst = j_rec.mlstm_forward(jp, jnp.asarray(x), H, return_state=True)
    got, tst = t_rec.mlstm_forward(tp, torch.from_numpy(x), H,
                                   return_state=True)
    moved, _ = j_rec.mlstm_forward(jp, jnp.asarray(_one_ulp(rs, x)), H,
                                   return_state=True)
    noise = float(np.abs(np.asarray(moved) - np.asarray(want)).max())
    tol = max(1e-5, 4 * noise)
    assert got.shape == want.shape
    _close(got, want, rtol=tol, atol=tol)
    for g, w in zip(tst, jst):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        _close(g, w, rtol=tol, atol=tol * scale)


def test_mlstm_decode_step_matches_reference():
    rs = np.random.RandomState(11)
    jp, tp = _params(j_rec.mlstm_specs(D, H))
    _, jst = j_rec.mlstm_forward(jp, jnp.asarray(_x(rs, 2, 32)), H,
                                 return_state=True)
    tst = t_rec.MLSTMState(*_state(jst))
    for _ in range(4):
        x = _x(rs, 2, 1)
        want, jst = j_rec.mlstm_decode_step(jp, jnp.asarray(x), jst, H)
        got, tst = t_rec.mlstm_decode_step(tp, torch.from_numpy(x), tst, H)
        _close(got, want)
        for g, w in zip(tst, jst):
            _close(g, w)


def test_mlstm_length_not_a_multiple_of_the_chunk_raises_in_both():
    jp, tp = _params(j_rec.mlstm_specs(D, H))
    x = _x(np.random.RandomState(12), 1, 300)
    with pytest.raises(AssertionError):
        j_rec.mlstm_forward(jp, jnp.asarray(x), H)
    with pytest.raises(ValueError, match="multiple"):
        t_rec.mlstm_forward(tp, torch.from_numpy(x), H)


# --- sLSTM -----------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 37])
def test_slstm_forward_and_state_match_reference(s):
    rs = np.random.RandomState(20 + s)
    jp, tp = _params(j_rec.slstm_specs(D, H))
    x = _x(rs, 2, s)
    want, jst = j_rec.slstm_forward(jp, jnp.asarray(x), H, return_state=True)
    got, tst = t_rec.slstm_forward(tp, torch.from_numpy(x), H,
                                   return_state=True)
    _close(got, want)
    for g, w in zip(tst, jst):
        _close(g, w)
    # decode continues the recurrence: four steps against the reference
    for _ in range(4):
        x = _x(rs, 2, 1)
        want, jst = j_rec.slstm_decode_step(jp, jnp.asarray(x), jst, H)
        got, tst = t_rec.slstm_decode_step(tp, torch.from_numpy(x), tst, H)
        _close(got, want)
        for g, w in zip(tst, jst):
            _close(g, w)


def test_slstm_init_state_matches_reference():
    for g, w in zip(t_rec.slstm_init_state(2, H, 8),
                    j_rec.slstm_init_state(2, H, 8)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(t_rec.mlstm_init_state(2, H, 8),
                    j_rec.mlstm_init_state(2, H, 8)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(t_rec.rglru_init_state(2, 24),
                    j_rec.rglru_init_state(2, 24)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --- RG-LRU ----------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 64, 300])
def test_rglru_forward_and_state_match_reference(s):
    rs = np.random.RandomState(30 + s)
    jp, tp = _params(j_rec.rglru_specs(D, 48))
    x = _x(rs, 2, s)
    want, jst = j_rec.rglru_forward(jp, jnp.asarray(x), return_state=True)
    got, tst = t_rec.rglru_forward(tp, torch.from_numpy(x),
                                   return_state=True)
    _close(got, want)
    for g, w in zip(tst, jst):
        _close(g, w)
    for _ in range(4):
        x = _x(rs, 2, 1)
        want, jst = j_rec.rglru_decode_step(jp, jnp.asarray(x), jst)
        got, tst = t_rec.rglru_decode_step(tp, torch.from_numpy(x), tst)
        _close(got, want)
        for g, w in zip(tst, jst):
            _close(g, w)


@pytest.mark.parametrize("s", [1, 2, 5, 64, 300])
def test_linear_scan_matches_associative_scan(s):
    """h_t = a_t h_{t-1} + b_t: the port's doubling scan against the
    reference's ``associative_scan`` and a sequential loop."""
    rs = np.random.RandomState(s)
    a = rs.uniform(0.5, 1.0, (2, s, 8)).astype(np.float32)
    b = rs.randn(2, s, 8).astype(np.float32)

    def combine(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    got = t_rec._linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    _close(got, want)
    h, seq = np.zeros((2, 8), np.float32), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    _close(got, np.stack(seq, 1))
