"""The MoE configurations (kimi-k2-1t-a32b with its shared expert,
arctic-480b with its dense residual FFN), the VLM backbone (internvl2-26b:
ViT patch embeddings before the tokens) and the encoder-only audio model
(hubert-xlarge: audio frames, non-causal attention, a class head) against
the JAX package on the CPU, reduced (``reduced()``: 8 experts, top-2, 4
patches or frames of 16 features, f32).

Parameters come from the reference's ``materialize`` and cross over as
numpy arrays (``convert.lm_params_from_jax``); tokens, patches and frames
come from ``numpy.random.RandomState``.  Logits, caches and the aux loss
are held at rtol = atol = 1e-5 (as ``test_torch_lm.py`` states), the
router's selected indices inside the model exactly, prefill against
teacher-forced decode at the JAX suite's 2e-3, and ``BatchedEngine``'s
tokens equal.  Also here: ``active_param_count`` at full size, and the
slice-by-slice draw of ``nn.module.materialize`` for large leaves.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.configs import base as j_base
from repro.models import lm as j_lm
from repro.nn import moe as j_moe
from repro.nn import module as j_module
from repro.serve import engine as j_engine
from repro_torch import configs as t_configs
from repro_torch.configs import base as t_base
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve as t_serve
from repro_torch.models import lm as t_lm
from repro_torch.nn import moe as t_moe
from repro_torch.nn import module as t_module
from repro_torch.serve import engine as t_engine

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
F32_TOL = dict(rtol=2e-3, atol=2e-3)   # prefill vs decode: the JAX suite's
ARCHS = ("kimi-k2-1t-a32b", "arctic-480b", "internvl2-26b", "hubert-xlarge")
DECODERS = ARCHS[:3]
SEQ = 24


def _cfgs(arch):
    return (j_base.reduced(j_configs.ARCHS[arch]),
            t_base.reduced(t_configs.ARCHS[arch]))


def _params(jc, seed=0):
    jp = jax.tree.map(np.asarray, j_module.materialize(
        j_lm.param_specs(jc), jax.random.PRNGKey(seed)))
    return jp, lm_params_from_jax(jp, device="cpu")


def _batch(cfg, rs, b, s) -> dict:
    """numpy inputs of ``b`` sequences: ``s`` frames for the audio model,
    else ``s`` tokens (after ``n_patches`` patches for the VLM)."""
    if cfg.frontend == "audio_frames":
        return {"frames": rs.randn(b, s, cfg.frontend_dim).astype(np.float32)}
    out = {"tokens": rs.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision_patches":
        out["patches"] = rs.randn(b, cfg.n_patches,
                                  cfg.frontend_dim).astype(np.float32)
    return out


def _both(batch: dict):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v).long() if k == "tokens"
             else torch.from_numpy(v) for k, v in batch.items()})


def _close(got: torch.Tensor, want, tol=None):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _cache_close(tcache, jcache):
    assert set(tcache) == set(jcache)
    for name in jcache:
        assert set(tcache[name]) == set(jcache[name]), name
        for key, want in jcache[name].items():
            got, want = tcache[name][key], np.asarray(want)
            assert tuple(got.shape) == want.shape, (name, key)
            assert got.numpy().dtype == want.dtype, (name, key)
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got.numpy(), want, rtol=TOL["rtol"],
                                       atol=TOL["atol"] * scale)


# --- configs, params, materialize -------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_layout_equal_reference(arch):
    """Full-size counts equal; at reduced size the reference's tree crosses
    leaf for leaf (the stacked ``moe`` router and experts, arctic's ``ffn``,
    kimi's ``shared``, ``patch_proj``, ``frontend_proj``, the class head)
    and the port's own specs give the same paths and shapes."""
    assert t_configs.ARCHS[arch].param_count() == \
        j_configs.ARCHS[arch].param_count()
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc)
    own = t_module.materialize(t_lm.param_specs(tc),
                               torch.Generator().manual_seed(0), device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(t_module.leaves(tp)) == len(t_module.leaves(own)) == len(flat)
    for path, a in flat:
        got, mine = tp, own
        for key in path:
            got, mine = got[key.key], mine[key.key]
        assert tuple(got.shape) == tuple(mine.shape) == a.shape, path
        assert got.numpy().dtype == a.dtype
        np.testing.assert_array_equal(got.numpy(), a)
    block = tp["layers"]["b0"]
    want = {"kimi-k2-1t-a32b": {"moe", "shared"},
            "arctic-480b": {"moe", "ffn"}}.get(arch, {"ffn"})
    assert want <= set(block) and not ({"moe", "ffn", "shared"} - want) \
        & set(block)
    if "moe" in block:
        e, d, f = tc.n_experts, tc.d_model, tc.d_ff
        assert tuple(block["moe"]["router"].shape) == (tc.n_groups, d, e)
        assert tuple(block["moe"]["w_out"].shape) == (tc.n_groups, e, f, d)
    if arch == "hubert-xlarge":
        assert "embed" not in tp and tuple(tp["head"]["w"].shape) == \
            (tc.d_model, tc.vocab_size)
        assert tuple(tp["frontend_proj"]["w"].shape) == \
            (tc.frontend_dim, tc.d_model)
    if arch == "internvl2-26b":
        assert tuple(tp["patch_proj"]["w"].shape) == \
            (tc.frontend_dim, tc.d_model)


@pytest.mark.parametrize("arch", sorted(j_configs.ARCHS))
def test_active_param_count_at_full_size_equals_reference(arch):
    """Specs only, no allocation; for kimi and arctic the reference's
    reckoning (every layer an MoE layer, the shared expert counted among
    the routed ones) kept as it is."""
    jc, tc = j_configs.ARCHS[arch], t_configs.ARCHS[arch]
    assert tc.active_param_count() == jc.active_param_count()
    if tc.moe:
        assert tc.active_param_count() < tc.param_count() // 8


def test_materialize_keeps_small_leaves_bits():
    """A leaf under ``DRAW_SLICE_ELEMENTS`` draws the bits of the former
    formula (one ``randn`` over its shape, ``z * scale``, cast), leaf by
    leaf in sorted-key order, for each init and an override dtype."""
    specs = {"a": t_module.ParamSpec((40, 24), (None, None)),
             "b": t_module.ParamSpec((7,), (None,), init="embed"),
             "c": t_module.ParamSpec((3, 5, 6), (None, None, None),
                                     scale=0.3),
             "d": t_module.ParamSpec((4,), (None,), init="zeros")}
    for dtype in (None, torch.bfloat16):
        got = t_module.materialize(specs, torch.Generator().manual_seed(5),
                                   dtype=dtype, device="cpu")
        gen = torch.Generator().manual_seed(5)
        for name, scale in (("a", 1.0 / math.sqrt(40)), ("b", 0.02),
                            ("c", 0.3)):
            z = torch.randn(specs[name].shape, generator=gen)
            want = (z * scale).to(dtype or torch.float32)
            assert torch.equal(got[name], want), (name, dtype)
        assert not got["d"].any()


def test_materialize_draws_large_leaves_in_slices(monkeypatch):
    """A leaf over ``DRAW_SLICE_ELEMENTS`` is drawn slice by slice along
    its flattened order: its dtype and shape are the spec's, its values
    have the spec's scale (fan-in, or the explicit one), and the slices
    are not copies of each other."""
    monkeypatch.setattr(t_module, "DRAW_SLICE_ELEMENTS", 1000)
    specs = {"w": t_module.ParamSpec((6, 256, 96), (None, None, None)),
             "e": t_module.ParamSpec((300, 40), (None, None), init="embed")}
    got = t_module.materialize(specs, torch.Generator().manual_seed(1),
                               dtype=torch.bfloat16, device="cpu")
    for name, scale in (("w", 1.0 / math.sqrt(256)), ("e", 0.02)):
        t = got[name]
        assert t.dtype == torch.bfloat16 and t.shape == specs[name].shape
        std = float(t.float().std())
        assert abs(std / scale - 1.0) < 0.02, (name, std, scale)
        assert abs(float(t.float().mean())) < 0.02 * scale
        flat = t.float().reshape(-1)
        assert not torch.equal(flat[:1000], flat[1000:2000])


# --- forward, prefill, decode ------------------------------------------------

def _routing_log(monkeypatch):
    """Record the selected experts of every router call, on both sides."""
    log = {"jax": [], "torch": []}
    j_route, t_route = j_moe.router_topk, t_moe.router_topk

    def j_rec(*a, **kw):
        out = j_route(*a, **kw)
        log["jax"].append(np.asarray(out[1]))
        return out

    def t_rec(*a, **kw):
        out = t_route(*a, **kw)
        log["torch"].append(out[1].numpy())
        return out

    monkeypatch.setattr(j_moe, "router_topk", j_rec)
    monkeypatch.setattr(t_moe, "router_topk", t_rec)
    return log


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(arch, monkeypatch):
    """Full forward and prefill: logits and the aux loss within 1e-5, the
    prefill's cache entry for entry, and every MoE layer's selected
    experts exactly."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, seed=1)
    jb, tb = _both(_batch(jc, np.random.RandomState(1), 2, SEQ))
    log = _routing_log(monkeypatch)
    with jax.disable_jit():        # the reference's scan as a loop: the
        want, w_aux = j_lm.forward(jp, jb, jc)   # router's outputs concrete
    got, g_aux = t_lm.forward(tp, tb, tc)
    s = SEQ + (tc.n_patches if tc.frontend == "vision_patches" else 0)
    v = tc.vocab_size if tc.encoder_only else tc.padded_vocab
    assert tuple(got.shape) == (2, s, v) and got.dtype == torch.float32
    _close(got, want)
    _close(g_aux, w_aux)
    assert (float(g_aux) > 0) == tc.moe
    with jax.disable_jit():
        want, w_aux, jcache = j_lm.forward(jp, jb, jc, prefill=True)
    got, g_aux, tcache = t_lm.forward(tp, tb, tc, prefill=True)
    assert tuple(got.shape) == (2, v)
    _close(got, want)
    _close(g_aux, w_aux)
    _cache_close(tcache, jcache)
    assert len(log["torch"]) == len(log["jax"]) == \
        (2 * tc.n_layers if tc.moe else 0)
    for g, w in zip(log["torch"], log["jax"]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", DECODERS)
def test_pad_cache_and_decode_match_reference(arch):
    """Prefill, ``pad_cache`` and 4 decode steps from the same cache on
    both sides: logits and the cache within 1e-5."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, seed=2)
    rs = np.random.RandomState(2)
    jb, tb = _both(_batch(jc, rs, 2, SEQ))
    _, _, jcache = j_lm.forward(jp, jb, jc, prefill=True)
    _, _, tcache = t_lm.forward(tp, tb, tc, prefill=True)
    p0 = SEQ + (tc.n_patches if tc.frontend == "vision_patches" else 0)
    jcache = j_lm.pad_cache(jcache, jc, p0 + 8)
    tcache = t_lm.pad_cache(tcache, tc, p0 + 8)
    for t in range(4):
        nt = rs.randint(0, jc.vocab_size, (2, 1)).astype(np.int32)
        pos = np.full((2,), p0 + t, np.int32)
        want, jcache = j_lm.decode_step(jp, jcache, jnp.asarray(nt),
                                        jnp.asarray(pos), jc)
        got, tcache = t_lm.decode_step(tp, tcache,
                                       torch.from_numpy(nt).long(),
                                       torch.from_numpy(pos).long(), tc)
        assert got.shape == (2, tc.padded_vocab)
        _close(got, want)
    _cache_close(tcache, jcache)


@pytest.mark.parametrize("arch", DECODERS)
def test_teacher_forced_decode_equals_prefill(arch):
    """The port against itself at the JAX suite's 2e-3: a prefill of the
    first half (after the patches for internvl2), then teacher-forced
    decode of the second half, against the full forward's logits at the
    same positions; and for the text-only decoders, decode from
    ``init_cache`` over the whole prompt against the prefill's last
    logits."""
    _, tc = _cfgs(arch)
    _, tp = _params(_cfgs(arch)[0], seed=3)
    batch = _both(_batch(tc, np.random.RandomState(3), 2, SEQ))[1]
    toks = batch["tokens"]
    full, _ = t_lm.forward(tp, batch, tc)
    half = SEQ // 2
    p0 = tc.n_patches if tc.frontend == "vision_patches" else 0
    _, _, cache = t_lm.forward(tp, dict(batch, tokens=toks[:, :half]), tc,
                               prefill=True)
    cache = t_lm.pad_cache(cache, tc, p0 + SEQ)
    for t in range(half, SEQ):
        got, cache = t_lm.decode_step(tp, cache, toks[:, t:t + 1],
                                      torch.full((2,), p0 + t), tc)
        _close(got, full[:, p0 + t].numpy(), F32_TOL)
    if tc.frontend is None:
        want, _, _ = t_lm.forward(tp, batch, tc, prefill=True)
        cache = t_lm.init_cache(tc, 2, SEQ, device="cpu")
        for t in range(SEQ):
            got, cache = t_lm.decode_step(tp, cache, toks[:, t:t + 1],
                                          torch.full((2,), t), tc)
        _close(got, want.numpy(), F32_TOL)


# --- serving -----------------------------------------------------------------

@pytest.mark.parametrize("arch", DECODERS)
def test_batched_engine_greedy_tokens_match_reference(arch):
    """Five requests of 3-5 tokens through three slots (two admitted as
    slots free), 5 new tokens each: the reference's tokens (internvl2
    served from text prompts, as the reference's engine serves it)."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, seed=7)
    rs = np.random.RandomState(7)
    prompts = [[int(t) for t in rs.randint(0, jc.vocab_size, 3 + u % 3)]
               for u in range(5)]
    out = []
    for eng, req in ((j_engine.BatchedEngine(jc, jax.tree.map(jnp.asarray, jp),
                                             batch_slots=3, s_max=32),
                      j_engine.Request),
                     (t_engine.BatchedEngine(tc, tp, batch_slots=3, s_max=32,
                                             device="cpu"),
                      t_engine.Request)):
        for uid, prompt in enumerate(prompts):
            eng.submit(req(uid=uid, prompt=prompt, max_new_tokens=5))
        out.append({r.uid: r.generated for r in eng.run(max_rounds=64)})
    assert out[1] == out[0] and sorted(out[1]) == list(range(5))
    assert all(len(t) == 5 for t in out[1].values())


@pytest.mark.parametrize("arch", DECODERS)
def test_launch_serve_smoke_on_cpu(arch, capsys):
    done = t_serve.main(["--smoke", "--device", "cpu", "--arch", arch,
                         "--requests", "4", "--max-new", "5"])
    assert len(done) == 4 and all(len(r.generated) == 5 for r in done)
    vocab = t_base.reduced(t_configs.ARCHS[arch]).vocab_size
    assert all(0 <= t < vocab for r in done for t in r.generated)
    assert "completed 4/4" in capsys.readouterr().out


def test_launch_serve_depth_cut_and_bf16_weights(capsys):
    """``--layers`` cuts the depth and ``--param-dtype bfloat16`` draws
    bf16 weights (how kimi-k2 and arctic are served on one card)."""
    done = t_serve.main(["--smoke", "--device", "cpu", "--arch",
                         "kimi-k2-1t-a32b", "--layers", "1", "--param-dtype",
                         "bfloat16", "--requests", "2", "--max-new", "3"])
    assert len(done) == 2 and all(len(r.generated) == 3 for r in done)
    assert "completed 2/2" in capsys.readouterr().out
