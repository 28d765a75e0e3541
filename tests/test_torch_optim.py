"""The LM trainer's parts in the port against the JAX package on the
CPU: the AdamW schedule, clipping and update (the decay of the stacked
norm scales, bf16 moments), SGD, gradient compression with error
feedback, the synthetic Zipf stream, the roofline constants, and the
AdamW state carried across from the reference.

Operands are the reference's gradients of a reduced smollm-135m (f32)
on tokens from ``numpy.random.RandomState``, carried across as numpy
arrays; tolerances are stated in each test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic_lm as j_data
from repro.roofline import analysis as j_roofline
from repro.train import compression as j_comp
from repro.train import optim as j_optim
from repro_torch.convert import adamw_state_from_jax, lm_params_from_jax
from repro_torch.data import synthetic_lm as t_data
from repro_torch.nn import module as t_module
from repro_torch.roofline import analysis as t_roofline
from repro_torch.train import compression as t_comp
from repro_torch.train import optim as t_optim
from tests.test_torch_lm_train import (_batch, _cfgs, _jax_loss_and_grads,
                                       _leaf, _ocfg, _params, _params_close,
                                       _tree_close)

torch.set_num_threads(1)


def _reference_grads(arch="smollm-135m", seed=0):
    """(JAX params, port params, JAX grads, port grads) of a reduced
    config's ``loss_fn``."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, seed)
    batch = _batch(jc, np.random.RandomState(seed + 6))
    _, _, jg = _jax_loss_and_grads(jc, jp, batch)
    jg = jax.tree.map(np.asarray, jg)
    return jp, tp, jg, lm_params_from_jax(jg, device="cpu")


# --- AdamW and SGD ----------------------------------------------------------

def test_schedule_matches_reference():
    """Bit for bit against the reference's schedule (its eager and
    vmapped form; XLA's fusion of the scalar function under ``jit``
    rounds a few values an ULP apart, which the train-step test's
    tolerance covers)."""
    for kw in ({}, {"warmup_steps": 100, "total_steps": 10000},
               {"warmup_steps": 0, "min_lr_frac": 0.0}):
        jo, to = _ocfg(**kw)
        steps = np.arange(0, to.total_steps + 10, max(1, to.total_steps // 40))
        want = np.asarray(jax.vmap(lambda s: j_optim.schedule(s, jo))(
            jnp.asarray(steps, jnp.int32)))
        got = np.array([float(t_optim.schedule(
            torch.tensor(int(s), dtype=torch.int32), to)) for s in steps],
            np.float32)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    _, _, jg, tg = _reference_grads()
    jclip, jnorm = j_optim.clip_by_global_norm(jg, max_norm)
    tclip, tnorm = t_optim.clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    np.testing.assert_allclose(float(t_optim.global_norm(tg)),
                               float(j_optim.global_norm(jg)), rtol=1e-6)
    for path, want in jax.tree_util.tree_flatten_with_path(jclip)[0]:
        np.testing.assert_allclose(_leaf(tclip, path).numpy(),
                                   np.asarray(want), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moments):
    """Three updates on the reference's gradients from the reference's
    state: parameters, moments, step, lr and grad norm.  The moments keep
    their dtype."""
    jp, tp, jg, tg = _reference_grads()
    jo, to = _ocfg(moment_dtype=moments)
    jstate, tstate = j_optim.adamw_init(jp, jo), t_optim.adamw_init(tp, to)
    lr_sum = 0.0
    for _ in range(3):
        jp, jstate, jstats = j_optim.adamw_update(jg, jstate, jp, jo)
        tp, tstate, tstats = t_optim.adamw_update(tg, tstate, tp, to)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tstats[key]),
                                       float(jstats[key]), rtol=1e-6)
        lr_sum += float(tstats["lr"])
    assert int(tstate.step) == int(jstate.step) == 3
    assert tstate.step.dtype == torch.int32
    _params_close(tp, jp, lr_sum)
    mtol = dict(rtol=1e-2, atol=1e-9) if moments == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-9)
    _tree_close(tstate.mu, jstate.mu, **mtol)
    _tree_close(tstate.nu, jstate.nu, **mtol)


def test_adamw_decays_every_leaf_of_two_or_more_dims():
    """With zero gradients the update is the weight decay alone: on every
    leaf of ndim >= 2, the stacked norm scales (G, D) of a layer group
    among them, and on none of ndim 1 (``final_norm``), as in the
    reference."""
    jp, tp, jg, tg = _reference_grads()
    jp["layers"]["b0"]["norm1"]["scale"] = np.full_like(
        jp["layers"]["b0"]["norm1"]["scale"], 0.5)
    jp["final_norm"]["scale"] = np.full_like(jp["final_norm"]["scale"], 0.5)
    tp = lm_params_from_jax(jp, device="cpu")
    zeros_j = jax.tree.map(np.zeros_like, jg)
    zeros_t = t_module.tree_map(torch.zeros_like, tg)
    jo, to = _ocfg()
    jnew, _, _ = j_optim.adamw_update(zeros_j, j_optim.adamw_init(jp, jo),
                                      jp, jo)
    tnew, _, stats = t_optim.adamw_update(zeros_t, t_optim.adamw_init(tp, to),
                                          tp, to)
    lr = float(stats["lr"])
    stacked = tnew["layers"]["b0"]["norm1"]["scale"]
    assert stacked.ndim == 2
    np.testing.assert_allclose(stacked.numpy(), 0.5 - lr * 0.1 * 0.5,
                               rtol=1e-6)
    assert torch.equal(tnew["final_norm"]["scale"], tp["final_norm"]["scale"])
    _tree_close(tnew, jnew, rtol=0, atol=1e-7)


def test_sgd_matches_reference():
    jp, tp, jg, tg = _reference_grads()
    js, ts = j_optim.sgd_init(jp), t_optim.sgd_init(tp)
    for _ in range(2):
        jp, js = j_optim.sgd_update(jg, js, jp)
        tp, ts = t_optim.sgd_update(tg, ts, tp)
    assert int(ts.step) == int(js.step) == 2
    _tree_close(tp, jp, rtol=1e-6, atol=1e-7)
    _tree_close(ts.momentum, js.momentum, rtol=1e-6, atol=1e-7)


# --- gradient compression -------------------------------------------------

def test_compress_matches_reference():
    _, _, jg, tg = _reference_grads()
    efb_j = jax.tree.map(lambda g: (0.01 * g).astype(np.float32), jg)
    efb_t = lm_params_from_jax(efb_j, device="cpu")
    for e_j, e_t in ((None, None), (efb_j, efb_t)):
        jc_, jerr = j_comp.compress(jg, e_j)
        tc_, terr = t_comp.compress(tg, e_t)
        for path, want in jax.tree_util.tree_flatten_with_path(jc_.q)[0]:
            got = _leaf(tc_.q, path)
            assert got.dtype == torch.int8
            assert np.abs(got.numpy().astype(int)
                          - np.asarray(want).astype(int)).max() <= 1
            assert np.mean(got.numpy() != np.asarray(want)) < 1e-3
        _tree_close(tc_.scale, jc_.scale, rtol=1e-7, atol=0)
        _tree_close(t_comp.decompress(tc_), j_comp.decompress(jc_),
                    rtol=0, atol=1e-9)
        np.testing.assert_allclose(
            float(t_optim.global_norm(terr)), float(j_optim.global_norm(jerr)),
            rtol=1e-3)


def test_compress_roundtrip_error_bounded():
    g = {"w": torch.from_numpy(np.random.RandomState(0).randn(64, 64)
                               .astype(np.float32))}
    comp, _ = t_comp.compress(g)
    out = t_comp.decompress(comp)
    scale = float(comp.scale["w"])
    assert float((out["w"] - g["w"]).abs().max()) <= scale * 0.5 + 1e-6


def test_error_feedback_reduces_bias():
    """Accumulated over 20 steps, the compressed gradient tracks the true
    sum more closely with error feedback than without (a biased stream:
    mean 0.005, sd 0.01)."""
    rs = np.random.RandomState(1)
    efb = t_comp.init_error_feedback({"w": torch.zeros((32, 32))})
    acc_fb = acc_raw = acc_true = torch.zeros((32, 32))
    for _ in range(20):
        g = {"w": torch.from_numpy((rs.randn(32, 32) * 0.01 + 0.005)
                                   .astype(np.float32))}
        comp_fb, efb = t_comp.compress(g, efb)
        comp_raw, _ = t_comp.compress(g)
        acc_fb = acc_fb + t_comp.decompress(comp_fb)["w"]
        acc_raw = acc_raw + t_comp.decompress(comp_raw)["w"]
        acc_true = acc_true + g["w"]
    err_fb = float((acc_fb - acc_true).abs().mean())
    err_raw = float((acc_raw - acc_true).abs().mean())
    assert err_fb <= err_raw * 1.05
    # the residual keeps the accumulated error within one step's scale
    assert float((acc_fb - acc_true).abs().max()) <= \
        float(comp_fb.scale["w"]) * 0.5 + 1e-6


def test_wire_ratio():
    g = {"w": torch.zeros((128, 128)), "b": {"c": torch.zeros(7)}}
    assert t_comp.compression_ratio(g) == 0.25 == j_comp.compression_ratio(
        {"w": jnp.zeros((128, 128)), "b": {"c": jnp.zeros(7)}})


# --- synthetic data -------------------------------------------------------

def test_synthetic_stateless_by_step():
    cfg = t_data.DataConfig(256, 64, 8, seed=3)
    b1 = t_data.SyntheticLM(cfg).batch_at(17)
    b2 = t_data.SyntheticLM(cfg).batch_at(17)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"],
                           t_data.SyntheticLM(cfg).batch_at(18)["tokens"])
    other = t_data.SyntheticLM(dataclasses.replace(cfg, seed=4))
    assert not torch.equal(b1["tokens"], other.batch_at(17)["tokens"])
    split = t_data.SyntheticLM(cfg).batch_at(17, n_micro=2)["tokens"]
    assert split.shape == (2, 4, 64)
    assert torch.equal(split.reshape(8, 64), b1["tokens"])
    assert b1["tokens"].dtype == torch.int64
    st = t_data.SyntheticLM(cfg).state(17)
    assert int(st["step"]) == 17 and int(st["seed"]) == 3


def _reference_copy(toks: np.ndarray, r: int) -> np.ndarray:
    """``synthetic_lm.py:46`` transcribed: the functional update reads
    the tokens as they were before any copy."""
    seq = toks.shape[1]
    out = toks.copy()
    dst = out[:, r::r]
    out[:, r::r] = toks[:, : (seq - r) // r * r: r][:, :dst.shape[1]]
    return out


@pytest.mark.parametrize("seq,rep", [(64, 8), (24, 8), (100, 5), (12, 4)])
def test_synthetic_copy_reads_pre_copy_tokens(seq, rep):
    data = t_data.SyntheticLM(t_data.DataConfig(50, seq, 4, seed=1,
                                                ngram_rep=rep))
    drawn = np.random.default_rng((1, 9)).random((4, seq))
    drawn = np.minimum(np.searchsorted(data._cdf, drawn, side="right"), 49)
    got = data.tokens_at(9)
    assert np.array_equal(got, _reference_copy(drawn, rep))
    # the reference's own expression on the same draw
    jt = jnp.asarray(drawn, jnp.int32)
    jt = jt.at[:, rep::rep].set(
        jt[:, : (seq - rep) // rep * rep: rep][:, :jt[:, rep::rep].shape[1]])
    assert np.array_equal(got, np.asarray(jt))
    assert np.array_equal(got[:, rep::rep], drawn[:, :-rep:rep][
        :, :got[:, rep::rep].shape[1]])
    # a chained in-place copy would differ: every copied position would
    # hold the row's first token
    chained = drawn.copy()
    for k in range(rep, seq, rep):
        chained[:, k] = chained[:, k - rep]
    if seq >= 3 * rep:
        assert not np.array_equal(got, chained)


def test_synthetic_unigram_near_zipf():
    """The drawn positions' frequencies follow the Zipf law the reference
    draws from, within four standard errors at the top ranks; the
    reference's own stream lands as close."""
    cfg = t_data.DataConfig(1000, 256, 64, seed=0)
    ranks = np.arange(1, 1001, dtype=np.float64)
    probs = ranks ** -1.2
    probs /= probs.sum()
    got = np.concatenate([t_data.SyntheticLM(cfg).tokens_at(s).ravel()
                          for s in range(4)])
    jdata = j_data.SyntheticLM(j_data.DataConfig(1000, 256, 64, seed=0))
    ref = np.concatenate([np.asarray(jdata.batch_at(s)["tokens"]).ravel()
                          for s in range(4)])
    n = got.size
    for toks in (got, ref):
        freq = np.bincount(toks, minlength=1000) / n
        se = np.sqrt(probs * (1 - probs) / n)
        assert np.all(np.abs(freq[:20] - probs[:20]) <= 4 * se[:20] + 1e-4)
        assert toks.min() >= 0 and toks.max() < 1000


# --- roofline and conversion ----------------------------------------------

def test_roofline_constants_and_model_flops():
    assert t_roofline.PEAK_FLOPS == 989e12
    assert t_roofline.HBM_BW == 3.35e12
    assert t_roofline.ICI_BW == 450e9
    for kind in ("train", "prefill"):
        assert t_roofline.model_flops(135_000_000, 16384, kind, 1) == \
            j_roofline.model_flops(135_000_000, 16384, kind, 1)
    r = t_roofline.Roofline(2 * 989e12, 3.35e12, 450e9, 989e12)
    assert (r.compute_s, r.memory_s, r.collective_s) == (2.0, 1.0, 1.0)
    assert r.dominant == "compute" and r.bound_s == 2.0
    assert r.useful_flops_frac == 0.5 and r.roofline_frac == 0.5
    assert set(r.as_dict()) == set(j_roofline.Roofline(1, 1, 1).as_dict())
    assert t_roofline.Roofline(0, 0, 0).roofline_frac == 0.0


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_state_from_jax(moments):
    jc, _ = _cfgs("smollm-135m")
    jp, tp = _params(jc)
    jo, _ = _ocfg(moment_dtype=moments)
    _, jstate, _ = j_optim.adamw_update(
        jax.tree.map(lambda p: jnp.full_like(p, 0.01), jp),
        j_optim.adamw_init(jp, jo), jp, jo)
    ts = adamw_state_from_jax(jstate, device="cpu")
    assert isinstance(ts, t_optim.AdamWState)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 1
    for got, want in ((ts.mu, jstate.mu), (ts.nu, jstate.nu)):
        for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
            g = _leaf(got, path)
            w = np.asarray(w)
            assert str(g.dtype) == f"torch.{w.dtype.name}"
            assert np.array_equal(g.float().numpy(), w.astype(np.float32))
