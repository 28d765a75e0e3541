"""The count that the NLQ kernel (``csrc/nlq_lut.cu``) takes for a sorted
codebook, mirrored in numpy, against the plain count and the JAX Pallas
kernel (interpret mode) on the CPU.

The kernel counts the boundaries strictly below x by a branch-free binary
search where the boundaries are non-decreasing and hold no NaN, and by the
linear count otherwise.  For every codebook the JAX package builds (nlq,
linear and activation ramps at 1, 2, 5, 6 and 8 bits) the mirror of that
choice and of the search must give ``ref.ramp_codes`` and the Pallas
kernel's codes exactly, with ties on every boundary, their f32 neighbours,
NaN, +-inf and +-0 among the inputs.  (XLA on the CPU flushes subnormal
inputs to zero before it compares, and neither the port's plain version
nor the kernel does: the neighbours of a boundary at 0 are held to the
plain count only.)  A permuted codebook must take the
linear count, which still equals the Pallas kernel; the search alone would
not.  Inputs come from ``numpy.random.RandomState``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ima as j_ima
from repro.kernels import ops as j_ops
from repro_torch.core import ima as t_ima
from repro_torch.kernels import ref as t_ref

KINDS = ["nlq", "linear", "activation"]
BITS = [1, 2, 5, 6, 8]


def _codebooks(kind: str, bits: int):
    if kind == "nlq":
        return (j_ima.nlq_codebook(bits, -24.0, 24.0),
                t_ima.nlq_codebook(bits, -24.0, 24.0))
    if kind == "linear":
        return (j_ima.linear_codebook(bits, -24.0, 24.0),
                t_ima.linear_codebook(bits, -24.0, 24.0))
    return (j_ima.activation_codebook(bits, j_ima.quadratic, -4.0, 4.0),
            t_ima.activation_codebook(bits, t_ima.quadratic, -4.0, 4.0))


def _inputs(rs, bounds: np.ndarray, span: float, shape=(37, 100)):
    """NaN, +-inf, +-0, every boundary and its two f32 neighbours, then
    uniform values across the ramp."""
    x = rs.uniform(-span, span, shape).astype(np.float32)
    special = np.concatenate([
        np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32), bounds,
        np.nextafter(bounds, np.float32(np.inf)),
        np.nextafter(bounds, np.float32(-np.inf))])
    assert special.size <= x.size
    x.flat[:special.size] = special
    return x


def _sorted(bounds: np.ndarray) -> bool:
    """The kernel's check: every adjacent pair b[i] <= b[i + 1] and no NaN
    (a NaN fails the compare; the last boundary is held to +inf)."""
    nxt = np.append(bounds[1:], np.float32(np.inf))
    return bool(np.all(bounds <= nxt))


def _search(x: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    """The kernel's binary search: ceil(log2 n_codes) steps over the
    boundaries padded with +inf to 2^bits - 1 entries; each step adds
    ``step`` where x > b[code + step - 1]."""
    bits = int(bounds.size).bit_length()          # ceil(log2 n_codes)
    padded = np.full((1 << bits) - 1, np.inf, np.float32)
    padded[:bounds.size] = bounds
    code = np.zeros(x.shape, np.int64)
    for s in reversed(range(bits)):
        step = 1 << s
        code += np.where(x > padded[code + step - 1], step, 0)
    return code.astype(np.int32)


def _kernel_codes(x: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    if _sorted(bounds):
        return _search(x, bounds)
    return (x[..., None] > bounds).sum(-1).astype(np.int32)


def _pallas_codes(x, bounds, levels) -> np.ndarray:
    jc, _ = j_ops.nlq_convert(jnp.asarray(x), jnp.asarray(bounds), levels)
    return np.asarray(jc)


def _normal(x: np.ndarray) -> np.ndarray:
    """Where x is not subnormal (the values XLA compares as they are)."""
    return (x == 0) | ~(np.abs(x) < np.finfo(np.float32).tiny)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("kind", KINDS)
def test_search_equals_plain_count_and_pallas_kernel(kind, bits):
    jcb, tcb = _codebooks(kind, bits)
    bounds = tcb.boundaries.numpy()
    np.testing.assert_array_equal(bounds, np.asarray(jcb.boundaries))
    assert bounds.size == 2 ** bits - 1 and _sorted(bounds)
    x = _inputs(np.random.RandomState(bits), bounds,
                5.0 if kind == "activation" else 30.0)
    got = _kernel_codes(x, bounds)
    plain = t_ref.ramp_codes(torch.from_numpy(x), tcb.boundaries).numpy()
    np.testing.assert_array_equal(got, plain)
    want = _pallas_codes(x, jcb.boundaries, jcb.levels)
    np.testing.assert_array_equal(got[_normal(x)], want[_normal(x)])
    assert got.flat[0] == 0 and got.flat[1] == bounds.size   # NaN, +inf
    assert got.flat[2] == 0                                  # -inf


@pytest.mark.parametrize("bits", [5, 6])
@pytest.mark.parametrize("kind", KINDS)
def test_permuted_codebook_takes_the_plain_count(kind, bits):
    jcb, tcb = _codebooks(kind, bits)
    rs = np.random.RandomState(100 + bits)
    perm = rs.permutation(2 ** bits - 1)
    bounds = tcb.boundaries.numpy()[perm]
    assert not _sorted(bounds)
    x = _inputs(rs, tcb.boundaries.numpy(),
                5.0 if kind == "activation" else 30.0)
    got = _kernel_codes(x, bounds)
    want = _pallas_codes(x, bounds, jcb.levels)
    np.testing.assert_array_equal(got[_normal(x)], want[_normal(x)])
    np.testing.assert_array_equal(got, t_ref.ramp_codes(
        torch.from_numpy(x), torch.from_numpy(bounds)).numpy())
    # the order check is what keeps the search off this codebook
    assert not np.array_equal(_search(x, bounds), got)


def test_nan_boundary_takes_the_plain_count():
    jcb, tcb = _codebooks("nlq", 5)
    bounds = tcb.boundaries.numpy().copy()
    bounds[30] = np.nan
    assert not _sorted(bounds)
    x = _inputs(np.random.RandomState(3), tcb.boundaries.numpy(), 30.0)
    got = _kernel_codes(x, bounds)
    want = _pallas_codes(x, bounds, jcb.levels)
    np.testing.assert_array_equal(got[_normal(x)], want[_normal(x)])
    np.testing.assert_array_equal(got, t_ref.ramp_codes(
        torch.from_numpy(x), torch.from_numpy(bounds)).numpy())
