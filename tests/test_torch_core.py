"""The port's core numerics against the JAX package, bit for bit, on the CPU.

Inputs come from ``numpy.random.RandomState`` and go to both sides as
numpy arrays.  Covered: ternary weights, the NLQ / linear codebooks, the
f32 elementary functions the noise path needs, Threefry,
``counter_normal`` / ``counter_sign`` / ``noisy_ima_codes``, and the
PRBS-15 LFSR in both of its draw orders.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ctrprng as j_ctr
from repro.core import ima as j_ima
from repro.core import prbs as j_prbs
from repro.core import ternary as j_ternary
from repro_torch.core import ctrprng as t_ctr
from repro_torch.core import f32math
from repro_torch.core import ima as t_ima
from repro_torch.core import prbs as t_prbs
from repro_torch.core import ternary as t_ternary

torch.set_num_threads(1)

SEEDS = (0, 1, 12345, 2 ** 31 - 1)
STEPS = (0, 1, 7, 1000)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --- ternary ---------------------------------------------------------------

def test_weight_decompose_and_quantize_match():
    rs = np.random.RandomState(0)
    w = rs.randn(64, 24).astype(np.float32) * 2
    w[0, :4] = [1.5, -2.5, 0.5, -0.5]                 # half-to-even ties
    j_int, j_scale = j_ternary.quantize_weights_3bit(jnp.asarray(w))
    t_int, t_scale = t_ternary.quantize_weights_3bit(torch.from_numpy(w))
    _eq(j_int, t_int)
    _eq(j_scale, t_scale)
    grid = np.arange(-3, 4, dtype=np.float32).repeat(3)
    for a, b in zip(j_ternary.weight_decompose(jnp.asarray(grid)),
                    t_ternary.weight_decompose(torch.from_numpy(grid))):
        _eq(a, b)
    msb, lsb = t_ternary.weight_decompose(torch.from_numpy(grid))
    _eq(t_ternary.weight_compose(msb, lsb), grid)
    _eq(t_ternary.pack_ternary(msb).numpy(),
        np.asarray(j_ternary.pack_ternary(j_ternary.weight_decompose(
            jnp.asarray(grid))[0])))
    ev = np.array([-1.4, -0.6, -0.2, 0.3, 0.5, 0.7, 2.0], np.float32)
    _eq(j_ternary.ternary_input_encode(jnp.asarray(ev)),
        t_ternary.ternary_input_encode(torch.from_numpy(ev)))


# --- codebooks -------------------------------------------------------------

@pytest.mark.parametrize("code_bits", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("lo,hi", [(-24.0, 24.0), (-64.0, 64.0),
                                   (-4.0, 4.0), (-10.0, 30.0)])
def test_codebooks_bit_for_bit(code_bits, lo, hi):
    for gamma in (2.0, 1.5):
        j = j_ima.nlq_codebook(code_bits, lo, hi, gamma)
        t = t_ima.nlq_codebook(code_bits, lo, hi, gamma)
        _eq(j.levels, t.levels)
        _eq(j.boundaries, t.boundaries)
        assert (j.in_lo, j.in_hi) == (t.in_lo, t.in_hi)
    j = j_ima.linear_codebook(code_bits, lo, hi)
    t = t_ima.linear_codebook(code_bits, lo, hi)
    _eq(j.levels, t.levels)
    _eq(j.boundaries, t.boundaries)


def test_convert_reconstruct_match():
    rs = np.random.RandomState(1)
    cb_j = j_ima.nlq_codebook(5, -24.0, 24.0)
    cb_t = t_ima.nlq_codebook(5, -24.0, 24.0)
    x = rs.randint(-40, 41, size=(16, 32)).astype(np.float32)
    x[0, : len(cb_t.boundaries)] = cb_t.boundaries.numpy()   # exact ties
    _eq(j_ima.ima_convert(jnp.asarray(x), cb_j),
        t_ima.ima_convert(torch.from_numpy(x), cb_t))
    _eq(j_ima.ima_quantize(jnp.asarray(x), cb_j),
        t_ima.ima_quantize(torch.from_numpy(x), cb_t))
    kn_j = j_ima.kernel_noise_params(j_ima.IMANoiseModel(), cb_j)
    kn_t = t_ima.kernel_noise_params(t_ima.IMANoiseModel(), cb_t)
    assert tuple(kn_j) == tuple(kn_t)


# --- f32 elementary functions ----------------------------------------------

def _unit_inputs(stride: int) -> np.ndarray:
    """Every ``stride``-th value ``counter_normal`` can feed to log."""
    k = np.arange(0, 2 ** 24, stride, dtype=np.float64)
    return ((k + 0.5) * 2.0 ** -24).astype(np.float32)


def test_logf_matches_reference():
    u = _unit_inputs(61)
    _eq(jax.jit(jnp.log)(u), f32math.logf(torch.from_numpy(u)))


def test_cosf_sinf_match_reference():
    u = _unit_inputs(67)
    theta = (np.float32(2.0 * math.pi) * u).astype(np.float32)
    _eq(jax.jit(jnp.cos)(theta), f32math.cosf(torch.from_numpy(theta)))
    rs = np.random.RandomState(2)
    x = np.concatenate([rs.uniform(-300, 300, 20000),
                        rs.uniform(-1, 1, 2000),
                        rs.uniform(-1e-3, 1e-3, 200),
                        rs.uniform(-1e5, 1e5, 200)]).astype(np.float32)
    _eq(jax.jit(jnp.sin)(x), f32math.sinf(torch.from_numpy(x)))
    _eq(jax.jit(jnp.cos)(x), f32math.cosf(torch.from_numpy(x)))


def test_sqrtf_and_fma_match_reference():
    rs = np.random.RandomState(3)
    x = rs.uniform(0, 40, 50000).astype(np.float32)
    _eq(jax.jit(jnp.sqrt)(x), f32math.sqrtf(torch.from_numpy(x)))
    v = rs.uniform(-8, 8, 50000).astype(np.float32)
    d = rs.uniform(-3, 3, 50000).astype(np.float32)
    # XLA fuses the LIF update into one FMA; a plain mul+add does not match
    j = jax.jit(lambda v, d: jnp.float32(0.9) * v + d)(v, d)
    _eq(j, f32math.fma(0.9, torch.from_numpy(v), torch.from_numpy(d)))
    assert (np.asarray(j) != np.float32(0.9) * v + d).any()


# --- counter PRNG ------------------------------------------------------------

def _grid(m=32, n=72):
    rows = np.broadcast_to(np.arange(m, dtype=np.int32)[:, None], (m, n))
    cols = np.broadcast_to(np.arange(n, dtype=np.int32)[None, :], (m, n))
    return rows.copy(), cols.copy()


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_normal_sign_bit_for_bit(seed):
    rows, cols = _grid()
    tr, tc = torch.from_numpy(rows).long(), torch.from_numpy(cols).long()
    for step in STEPS:
        k1 = j_ctr.TAG_IMA ^ step
        jb = j_ctr.threefry2x32(seed, jnp.uint32(k1), rows, cols)
        tb = t_ctr.threefry2x32(seed, k1, tr, tc)
        for a, b in zip(jb, tb):
            _eq(np.asarray(a).astype(np.int64), b)
        _eq(j_ctr.counter_normal(seed, step, rows, cols, j_ctr.TAG_IMA),
            t_ctr.counter_normal(seed, step, tr, tc, t_ctr.TAG_IMA))
        _eq(j_ctr.counter_sign(seed, step, rows, cols, j_ctr.TAG_SNL),
            t_ctr.counter_sign(seed, step, tr, tc, t_ctr.TAG_SNL))


@pytest.mark.parametrize("seed", SEEDS)
def test_noisy_ima_codes_bit_for_bit(seed):
    rs = np.random.RandomState(seed % 1000)
    rows, cols = _grid()
    cb = j_ima.nlq_codebook(5, -24.0, 24.0)
    kn = j_ima.kernel_noise_params(j_ima.IMANoiseModel(), cb)
    codes = jax.jit(lambda a, b, r, c, sd, st: j_ctr.noisy_ima_codes(
        a, b, r, c, sd, st, kn, 32))
    for step in STEPS:
        x = rs.randint(-60, 61, size=rows.shape).astype(np.float32)
        ideal = np.array(j_ima.ima_convert(jnp.asarray(x), cb))
        j = codes(ideal, x, rows, cols, np.int32(seed), np.int32(step))
        t = t_ctr.noisy_ima_codes(torch.from_numpy(ideal), torch.from_numpy(x),
                                  torch.from_numpy(rows).long(),
                                  torch.from_numpy(cols).long(), seed, step,
                                  kn, 32)
        _eq(j, t)


# --- PRBS ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2, 500, 32766, 40000])
def test_prbs_sequence_path_order(seed):
    """One LFSR drawing b * n bits per step, step after step."""
    t, b, n = 5, 3, 11
    s = j_prbs.lfsr_init(seed)
    steps = []
    for _ in range(t):
        s, nz = j_prbs.prbs_noise(s, (b, n), 0.05)
        steps.append(np.asarray(nz))
    state0 = torch.tensor([t_prbs.lfsr_init(seed)])
    new, bits = t_prbs.draw(state0, t * b * n)
    got = t_prbs.bits_to_noise(bits[0], 0.05).reshape(t, b, n)
    _eq(np.stack(steps), got)
    assert int(new[0]) == int(s)


def test_prbs_stream_path_order():
    """One LFSR per slot drawing n bits per step (R steps a round)."""
    r, n = 4, 9
    seeds = [1, 77, 3000, 32000]
    want = []
    ends = []
    for sd in seeds:
        s = j_prbs.lfsr_init(sd)
        rows = []
        for _ in range(r):
            s, nz = j_prbs.prbs_noise(s, (n,), 0.05)
            rows.append(np.asarray(nz))
        want.append(np.stack(rows))
        ends.append(int(s))
    states = torch.tensor([t_prbs.lfsr_init(sd) for sd in seeds])
    new, bits = t_prbs.draw(states, r * n)
    got = t_prbs.bits_to_noise(bits, 0.05).reshape(len(seeds), r, n)
    _eq(np.stack(want), got)
    assert new.tolist() == ends
