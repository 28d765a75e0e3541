"""The composed chain's four single-stage kernels: the port's plain
versions against the JAX Pallas kernels (interpret mode, through
``repro.kernels.ops``) on the CPU.

``ternary_mac``, ``nlq_convert``, ``kwn_topk`` and ``lif_step`` are held
bit for bit (the MAC at an integral ratio; at a non-integral ratio the
reference's f32 accumulation rounds at every add and the port's result
once, so the two agree within 1e-6 of the sum of the absolute products).
The LIF follows the Pallas kernel, whose compiled body contracts ``beta *
v + drive`` into a fused multiply-add, not the eager oracle
``ref.lif_step_ref``.  Operands come from ``numpy.random.RandomState``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ima as j_ima
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.core import ima as t_ima
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

torch.set_num_threads(1)

LIF_KW = dict(beta=0.9, v_th1=1.0, v_th2=0.6, v_reset=0.0, v_lim=8.0)


def _tern(rs, *shape):
    return rs.randint(-1, 2, size=shape).astype(np.int8)


def _codebooks(kind: str, bits: int):
    if kind == "nlq":
        return (j_ima.nlq_codebook(bits, -24.0, 24.0),
                t_ima.nlq_codebook(bits, -24.0, 24.0))
    if kind == "linear":
        return (j_ima.linear_codebook(bits, -24.0, 24.0),
                t_ima.linear_codebook(bits, -24.0, 24.0))
    return (j_ima.activation_codebook(bits, j_ima.quadratic, -4.0, 4.0),
            t_ima.activation_codebook(bits, t_ima.quadratic, -4.0, 4.0))


def _ramp_inputs(rs, kind, cb, shape):
    """Values across the ramp's range, integral for the MAC ramps, with
    the boundaries themselves planted (ties: a boundary is not below)."""
    lo, hi = (-30.0, 30.0) if kind != "activation" else (-5.0, 5.0)
    x = rs.uniform(lo, hi, shape).astype(np.float32)
    if kind != "activation":
        x = np.round(x).astype(np.float32)
    b = cb.boundaries.numpy()
    x.flat[:b.size] = b
    return x


@pytest.mark.parametrize("ratio", [2.0, 3.0])
@pytest.mark.parametrize("shape", [(64, 512, 128), (128, 256, 128),
                                   (37, 300, 100), (1, 33, 7)], ids=str)
def test_ternary_mac_matches_pallas_kernel(shape, ratio):
    m, k, n = shape
    rs = np.random.RandomState(m + k + n)
    x, msb, lsb = _tern(rs, m, k), _tern(rs, k, n), _tern(rs, k, n)
    want = np.asarray(j_ops.ternary_mac(jnp.asarray(x), jnp.asarray(msb),
                                        jnp.asarray(lsb), ratio=ratio))
    got = t_ops.ternary_mac(x, msb, lsb, ratio=ratio, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32 and np.abs(want).max() > 0


@pytest.mark.parametrize("shape, density", [
    ((64, 512, 128), 0.67),     # the chain's step shape, dense events
    ((37, 1000, 100), 0.05),    # a long ragged K
    ((37, 1000, 100), 0.67)], ids=str)
def test_ternary_mac_dense_events_and_long_k(shape, density):
    """The plain version the card's tensor-core kernel is held to, against
    the Pallas kernel at a density where most inputs fired and at K =
    1000 (more than one macro's rows, not a multiple of 16)."""
    m, k, n = shape
    rs = np.random.RandomState(k + int(100 * density))
    x = rs.choice([-1, 0, 1], p=[density / 2, 1 - density, density / 2],
                  size=(m, k)).astype(np.int8)
    msb, lsb = _tern(rs, k, n), _tern(rs, k, n)
    want = np.asarray(j_ops.ternary_mac(jnp.asarray(x), jnp.asarray(msb),
                                        jnp.asarray(lsb)))
    got = t_ops.ternary_mac(x, msb, lsb, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert abs((x != 0).mean() - density) < 0.02


def test_ternary_mac_without_inputs_is_zero():
    """K = 0 (a layer with no inputs): every MAC is 0, leading batch
    dimensions kept, as ``x @ w`` of an empty contraction gives."""
    x = np.zeros((2, 3, 0), dtype=np.int8)
    w = np.zeros((0, 5), dtype=np.int8)
    got = t_ops.ternary_mac(x, w, w, ratio=2.05, device="cpu")
    assert got.shape == (2, 3, 5) and got.dtype == torch.float32
    assert not got.any()


def test_ternary_mac_leading_batch_dims():
    rs = np.random.RandomState(3)
    x = _tern(rs, 2, 5, 300)
    msb, lsb = _tern(rs, 300, 130), _tern(rs, 300, 130)
    want = np.asarray(j_ops.ternary_mac(jnp.asarray(x), jnp.asarray(msb),
                                        jnp.asarray(lsb)))
    got = t_ops.ternary_mac(x, msb, lsb, device="cpu")
    assert got.shape == (2, 5, 130)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ternary_mac_nonintegral_ratio():
    """ratio 2.05: the reference rounds at every f32 add of its K-long
    accumulation, the port once (``fma(ratio, x @ msb, x @ lsb)`` of two
    exact integers); they agree within 1e-6 of sum |x_i w_i|."""
    rs = np.random.RandomState(5)
    x, msb, lsb = _tern(rs, 37, 300), _tern(rs, 300, 100), _tern(rs, 300, 100)
    ratio = 2.05
    want = np.asarray(j_ops.ternary_mac(jnp.asarray(x), jnp.asarray(msb),
                                        jnp.asarray(lsb), ratio=ratio))
    got = t_ops.ternary_mac(x, msb, lsb, ratio=ratio, device="cpu").numpy()
    w = np.float32(ratio) * msb.astype(np.float64) + lsb
    scale = np.abs(x).astype(np.float64) @ np.abs(w)
    assert (np.abs(got.astype(np.float64) - want) <= 1e-6 * scale).all()
    exact = x.astype(np.float64) @ w
    # the port's single rounding is the nearer one
    assert np.abs(got - exact).max() <= np.abs(want - exact).max()


@pytest.mark.parametrize("bits", [5, 6])
@pytest.mark.parametrize("kind", ["nlq", "linear", "activation"])
def test_nlq_convert_matches_pallas_kernel(kind, bits):
    rs = np.random.RandomState(bits)
    jcb, tcb = _codebooks(kind, bits)
    np.testing.assert_array_equal(tcb.boundaries.numpy(),
                                  np.asarray(jcb.boundaries))
    x = _ramp_inputs(rs, kind, tcb, (37, 100))
    jc, jy = j_ops.nlq_convert(jnp.asarray(x), jcb.boundaries, jcb.levels)
    tc, ty = t_ops.nlq_convert(x, tcb.boundaries, tcb.levels, device="cpu")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert tc.dtype == torch.int32 and len(np.unique(tc.numpy())) > 4


@pytest.mark.parametrize("k", [0, 1, 12, 100, 128])
@pytest.mark.parametrize("kind", ["nlq", "linear"])
def test_kwn_topk_matches_pallas_kernel(kind, k):
    """Every winner count the TPU kernel's sweep defines: none (step 0),
    one, the paper's 12, all N, and more than N; integral MACs tie."""
    rs = np.random.RandomState(k)
    jcb, tcb = _codebooks(kind, 5)
    x = _ramp_inputs(rs, kind, tcb, (37, 100))
    jm, js = j_ops.kwn_topk(jnp.asarray(x), jcb.boundaries, k)
    tm, ts = t_ops.kwn_topk(x, tcb.boundaries, k, device="cpu")
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (tm.sum(-1) == min(max(k, 0), 100)).all()
    if k == 0:
        assert not ts.any()


def test_kwn_topk_batched_and_six_bit():
    rs = np.random.RandomState(11)
    jcb, tcb = _codebooks("nlq", 6)
    x = np.round(rs.normal(0, 9, (3, 7, 256))).astype(np.float32)
    jm, js = j_ops.kwn_topk(jnp.asarray(x), jcb.boundaries, 16)
    tm, ts = t_ops.kwn_topk(x, tcb.boundaries, 16, device="cpu")
    assert tm.shape == (3, 7, 256) and ts.shape == (3, 7)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _lif_inputs(rs, shape):
    v = rs.uniform(-1.5, 1.5, shape).astype(np.float32)
    drive = rs.normal(0, 0.5, shape).astype(np.float32)
    mask = (rs.uniform(size=shape) < 0.3).astype(np.float32)
    noise = (0.05 * rs.choice([-1.0, 1.0], size=shape)).astype(np.float32)
    return v, drive, mask, noise


@pytest.mark.parametrize("use_snl", [True, False], ids=["snl", "no_snl"])
@pytest.mark.parametrize("shape", [(64, 128), (33, 100), (2, 3, 40)],
                         ids=str)
def test_lif_step_matches_pallas_kernel(shape, use_snl):
    rs = np.random.RandomState(len(shape) + shape[0])
    args = _lif_inputs(rs, shape)
    jv, js = j_ops.lif_step(*(jnp.asarray(a) for a in args), use_snl=use_snl,
                            **LIF_KW)
    tv, ts = t_ops.lif_step(*args, use_snl=use_snl, device="cpu", **LIF_KW)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts.sum() > 0


def test_lif_follows_the_kernel_not_the_eager_oracle():
    """The Pallas kernel computes ``fma(beta, v, drive)``; the eager
    ``ref.lif_step_ref`` rounds ``beta * v`` first.  On inputs where the
    two differ, the port (its wrapper and its plain version) equals the
    kernel and so differs from the oracle."""
    rs = np.random.RandomState(0)
    v, drive, mask, noise = _lif_inputs(rs, (64, 128))
    mask[:] = 1.0
    j_args = [jnp.asarray(a) for a in (v, drive, mask, noise)]
    kv, _ = j_ops.lif_step(*j_args, **LIF_KW)
    ev, _ = j_ref.lif_step_ref(*j_args, **LIF_KW)
    tv, _ = t_ops.lif_step(v, drive, mask, noise, device="cpu", **LIF_KW)
    kv, ev, tv = np.asarray(kv), np.asarray(ev), tv.numpy()
    differ = kv != ev
    assert differ.sum() > 100
    np.testing.assert_array_equal(tv, kv)
    assert (tv[differ] != ev[differ]).all()
    fused = t_ref.lif_step_ref(*(torch.from_numpy(a) for a in
                                 (v, drive, mask, noise)), **LIF_KW)[0]
    np.testing.assert_array_equal(fused.numpy(), kv)


def _jax_chain(x, msb, lsb, jcb, scale, v, noise, k, gain):
    out = []
    for t in range(x.shape[0]):
        mac = j_ops.ternary_mac(x[t], msb, lsb)
        _, mac_q = j_ops.nlq_convert(mac, jcb.boundaries, jcb.levels)
        mask, steps = j_ops.kwn_topk(mac, jcb.boundaries, k)
        drive = mac_q * scale * mask * gain
        v, spk = j_ops.lif_step(v, drive, mask, noise[t], **LIF_KW)
        out.append((np.asarray(spk), np.asarray(steps)))
    return np.asarray(v), out


def test_chain_matches_jax_chain():
    """``ternary_mac -> nlq_convert -> kwn_topk -> lif_step`` over a few
    steps (the bench's ``_composed_step``, iterated) against the same
    chain of Pallas kernels: spikes, ADC steps and membranes bit for
    bit."""
    rs = np.random.RandomState(7)
    t, m, k_dim, n, k, gain = 4, 24, 300, 100, 12, 0.25
    x = (rs.choice([-1, 0, 1], p=[0.1, 0.8, 0.1], size=(t, m, k_dim))
         .astype(np.int8))
    msb, lsb = _tern(rs, k_dim, n), _tern(rs, k_dim, n)
    scale = rs.uniform(0.05, 0.3, n).astype(np.float32)
    v0 = rs.normal(0, 0.5, (m, n)).astype(np.float32)
    noise = (0.05 * rs.choice([-1.0, 1.0], size=(t, m, n))).astype(np.float32)
    jcb, tcb = _codebooks("nlq", 5)
    jv, jout = _jax_chain(jnp.asarray(x), jnp.asarray(msb), jnp.asarray(lsb),
                          jcb, jnp.asarray(scale), jnp.asarray(v0),
                          jnp.asarray(noise), k, gain)
    v = torch.from_numpy(v0)
    scale_t = torch.from_numpy(scale)
    n_spikes = 0
    for step in range(t):
        mac = t_ops.ternary_mac(x[step], msb, lsb, device="cpu")
        _, mac_q = t_ops.nlq_convert(mac, tcb.boundaries, tcb.levels,
                                     device="cpu")
        mask, steps = t_ops.kwn_topk(mac, tcb.boundaries, k, device="cpu")
        drive = mac_q * scale_t * mask * gain
        v, spk = t_ops.lif_step(v, drive, mask, noise[step], device="cpu",
                                **LIF_KW)
        np.testing.assert_array_equal(spk.numpy(), jout[step][0])
        np.testing.assert_array_equal(steps.numpy(), jout[step][1])
        n_spikes += int(spk.sum())
    np.testing.assert_array_equal(v.numpy(), jv)
    assert n_spikes > 0
