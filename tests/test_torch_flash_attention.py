"""The flash-attention kernel's plain version against the JAX Pallas
kernel (interpret mode) and XLA's ``blockwise_attention`` on the CPU.

``kernels.flash_attention.flash_attention_fwd`` on a CPU tensor runs the
plain version ``kernels.ref.flash_attention_ref`` (one softmax over the
whole row, where the kernels take an online one over kv blocks): the two
sides differ only in the order of their f32 sums.  Tolerances are the JAX
suite's own (``tests/test_flash_attention.py``): rtol = atol = 2e-5 in
f32; bf16 outputs within one bf16 ULP
(both round an f32 value, which may sit on either side of a rounding
boundary) or within the f32 tolerance's 2e-5 absolutely (an output that
cancels to near zero, where the f32 sums' order decides every bit).
Operands come from ``numpy.random.RandomState``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as j_flash
from repro.nn import attention as j_attention
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels import ref as t_ref

torch.set_num_threads(1)

F32_TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, shape, scale=1.0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*shape) * scale).astype(np.float32) for _ in range(3)]


def _port(q, k, v, causal, dtype=torch.float32):
    return t_flash.flash_attention_fwd(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)), causal=causal)


@pytest.mark.parametrize("s,bq,bk", [(128, 32, 32), (256, 64, 64),
                                     (128, 64, 32), (192, 64, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_pallas_kernel(s, bq, bk, causal):
    q, k, v = _qkv(s + bq, (2, s, 16))
    want = j_flash.flash_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal,
                                       bq=bq, bk=bk)
    got = _port(q, k, v, causal)
    assert got.dtype == torch.float32 and got.shape == (2, s, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ULP at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_inputs_within_one_ulp_of_pallas_kernel(causal):
    q, k, v = _qkv(9, (2, 128, 32))
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(j_flash.flash_attention_fwd(
        qb, kb, vb, causal=causal, bq=64, bk=64), dtype=np.float32)
    # the same bf16 inputs on both sides
    qt, kt, vt = (torch.from_numpy(np.asarray(a, dtype=np.float32))
                  .to(torch.bfloat16) for a in (qb, kb, vb))
    got = t_flash.flash_attention_fwd(qt, kt, vt, causal=causal)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    big = np.maximum(np.abs(got), np.abs(want))
    assert np.all(np.abs(got - want) <= np.maximum(_bf16_ulp(big), 2e-5))


HEAD_DIMS = [21, 80, 112, 192, 256]     # reduced configs and the registry's


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_pallas_kernel_at_head_dims(d, causal):
    """Head dims that are not powers of two (21 from ``reduced()``; 80
    hubert-xlarge, 112 kimi-k2, 192 nemotron-4-340b) and 256 (gemma2,
    recurrentgemma, xlstm): the Pallas kernel's blocks take any D, and so
    does the plain version the card's kernel is held to."""
    q, k, v = _qkv(d, (2, 128, d))
    want = j_flash.flash_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal,
                                       bq=64, bk=64)
    got = _port(q, k, v, causal)
    assert got.shape == (2, 128, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("d", [80, 256])
def test_bf16_within_one_ulp_of_pallas_kernel_at_head_dims(d):
    q, k, v = _qkv(d + 1, (2, 128, d))
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(j_flash.flash_attention_fwd(
        qb, kb, vb, causal=True, bq=64, bk=64), dtype=np.float32)
    got = t_flash.flash_attention_fwd(
        *(torch.from_numpy(np.asarray(a, dtype=np.float32))
          .to(torch.bfloat16) for a in (qb, kb, vb)), causal=True)
    got = got.float().numpy()
    big = np.maximum(np.abs(got), np.abs(want))
    assert np.all(np.abs(got - want) <= np.maximum(_bf16_ulp(big), 2e-5))


def test_large_logits_stay_finite_and_match():
    """The JAX suite's large-logit case (inputs x30, scores up to ~1e3)
    with integer-valued inputs: the scores are then exact in any sum order,
    and the case checks what it is for, the online softmax at large
    scores, at the f32 tolerance.  With non-integral inputs the scores'
    own f32 rounding (~1e-4 at 1e3), amplified by exp, lets any two sum
    orders differ by up to ~3e-3 relative (seen over eight draws)."""
    q, k, v = (np.round(a) for a in _qkv(11, (1, 128, 16), scale=30.0))
    want = j_flash.flash_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=True,
                                       bq=32, bk=32)
    got = _port(q, k, v, True)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("s", [1, 13, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_ragged_sequence_matches_blockwise_attention(s, causal):
    """S that no block size divides, against the reference's XLA path in
    its (B, S, H, hd) layout."""
    b, h, hd = 2, 3, 16
    q, k, v = _qkv(s, (b, s, h, hd))
    want = j_attention.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), causal=causal)

    def heads_first(a):
        return torch.from_numpy(a).transpose(1, 2).reshape(b * h, s, hd)

    got = t_flash.flash_attention_fwd(heads_first(q), heads_first(k),
                                      heads_first(v), causal=causal)
    got = got.reshape(b, h, s, hd).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("s,bq,bk", [(32768, 512, 512), (4096, 1024, 1024),
                                     (2048, 128, 128), (192, 64, 32),
                                     (128, 128, 128)])
def test_causal_flops_saving_equals_reference(s, bq, bk):
    assert t_flash.causal_flops_saving(s, bq, bk) == \
        j_flash.causal_flops_saving(s, bq, bk)


def test_wrapper_raises_when_an_input_requires_grad():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, (1, 8, 16)))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        t_flash.flash_attention_fwd(q, k, v)
    with torch.no_grad():
        out = t_flash.flash_attention_fwd(q, k, v)
    assert out.shape == (1, 8, 16)


def test_wrapper_takes_only_cpu_or_cuda_tensors():
    q = torch.zeros((1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        t_flash.flash_attention_fwd(q, q, q)


def test_plain_version_is_the_wrapper_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, (4, 70, 32)))
    for causal in (True, False):
        assert torch.equal(t_flash.flash_attention_fwd(q, k, v, causal),
                           t_ref.flash_attention_ref(q, k, v, causal))
