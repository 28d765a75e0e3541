"""The LM port against the JAX package on the CPU: configs, params, the
full-sequence forward, prefill, ``pad_cache``, decode and
``BatchedEngine``.

The JAX parameters come from ``repro.nn.module.materialize`` and cross
over as numpy arrays (``convert.lm_params_from_jax``); tokens come from
``numpy.random.RandomState``.  Everything runs in f32 (``reduced()``
sets it).  Logits and caches are held at rtol = atol = 1e-5: the two
sides round the same f32 operations in another order (matmul and
softmax sums, ``rsqrt``, ``cos`` / ``sin`` within an ULP), which moves
logits of magnitude ~1 by ~1e-6 (2.6e-6 seen).  Greedy tokens are equal
wherever the top-2 logit gap exceeds that tolerance; a near tie may flip.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.configs import base as j_base
from repro.launch import serve as j_serve
from repro.models import lm as j_lm
from repro.nn import attention as j_attention
from repro.nn import layers as j_layers
from repro.nn import module as j_module
from repro.serve import engine as j_engine
from repro_torch import configs as t_configs
from repro_torch.configs import base as t_base
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve as t_serve
from repro_torch.models import lm as t_lm
from repro_torch.nn import attention as t_attention
from repro_torch.nn import layers as t_layers
from repro_torch.nn import module as t_module
from repro_torch.serve import engine as t_engine

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("smollm-135m", "qwen2.5-32b", "nemotron-4-340b")


def _cfgs(arch, **kw):
    return (dataclasses.replace(j_base.reduced(j_configs.ARCHS[arch]), **kw),
            dataclasses.replace(t_base.reduced(t_configs.ARCHS[arch]), **kw))


def _params(jc, seed=0):
    jp = jax.tree.map(np.asarray, j_module.materialize(
        j_lm.param_specs(jc), jax.random.PRNGKey(seed)))
    return jp, lm_params_from_jax(jp, device="cpu")


def _tokens(rs, vocab, shape):
    return rs.randint(0, vocab, shape).astype(np.int32)


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


# --- configs and params -----------------------------------------------------

def test_registry_equals_reference_field_for_field():
    assert set(t_configs.ARCHS) == set(j_configs.ARCHS)
    for name, jc in j_configs.ARCHS.items():
        tc = t_configs.get_config(name)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), name
        for fn in (lambda m, c: m.reduced(c),
                   lambda m, c: m.reduced(c, n_layers=3, d_model=32),
                   lambda m, c: m.optimized(c),
                   lambda m, c: m.optimized(c, serving=True)):
            assert dataclasses.asdict(fn(t_base, tc)) == \
                dataclasses.asdict(fn(j_base, jc)), name
    assert t_configs.SHAPE_SKIPS == j_configs.SHAPE_SKIPS
    assert t_configs.cells() == j_configs.cells()
    with pytest.raises(KeyError):
        t_configs.get_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS + ("gemma2-2b",))
def test_param_count_equals_reference(arch):
    jc, tc = j_configs.ARCHS[arch], t_configs.ARCHS[arch]
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert tc.padded_vocab == jc.padded_vocab
    if arch == "smollm-135m":
        assert tc.param_count() == 134_515_008


def test_compute_dtype_is_a_torch_dtype():
    assert t_configs.ARCHS["smollm-135m"].compute_dtype == torch.bfloat16
    assert t_base.reduced(t_configs.ARCHS["smollm-135m"]).compute_dtype \
        == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_materialize_follows_the_reference_layout_and_scales(arch):
    jc, tc = _cfgs(arch)
    jp, _ = _params(jc)
    tp = t_module.materialize(t_lm.param_specs(tc),
                              torch.Generator().manual_seed(0),
                              device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(t_module.leaves(tp)) == len(flat_j)
    for path, a in flat_j:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32
    emb = tp["embed"]["table"]
    assert abs(float(emb.std()) - 0.02) < 0.002
    w = tp["layers"]["b0"]["ffn"]["w_in"]["w"]
    assert abs(float(w.std()) * tc.d_model ** 0.5 - 1.0) < 0.05
    assert not tp["final_norm"]["scale"].any()
    again = t_module.materialize(t_lm.param_specs(tc),
                                 torch.Generator().manual_seed(0),
                                 device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(t_module.leaves(tp),
                                                 t_module.leaves(again)))


# --- layers -------------------------------------------------------------------

def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def test_activations_match_reference():
    """relu and squared ReLU bit for bit; silu within 2 ULP; gelu is the
    tanh approximation (``jax.nn.gelu``'s default) within 1e-6."""
    x = (np.random.RandomState(0).randn(20000) * 4).astype(np.float32)
    xt = torch.from_numpy(x)
    for name, fn in j_layers.ACTIVATIONS.items():
        want = np.asarray(fn(jnp.asarray(x)))
        got = t_layers.ACTIVATIONS[name](xt).numpy()
        if name in ("relu", "squared_relu"):
            assert np.array_equal(got, want), name
        elif name == "silu":
            assert _ulps(got, want) <= 2
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    erf_gelu = torch.nn.functional.gelu(xt).numpy()
    assert np.abs(erf_gelu - t_layers.ACTIVATIONS["gelu"](xt).numpy()).max() \
        > 1e-5


def test_rmsnorm_rope_and_repeat_kv_match_reference():
    rs = np.random.RandomState(1)
    x = rs.randn(4, 7, 32).astype(np.float32)
    sc = (rs.randn(32) * 0.1).astype(np.float32)
    want = np.asarray(j_layers.rmsnorm({"scale": jnp.asarray(sc)},
                                       jnp.asarray(x)))
    got = t_layers.rmsnorm({"scale": torch.from_numpy(sc)},
                           torch.from_numpy(x)).numpy()
    assert _ulps(got, want) <= 4      # rsqrt and the mean's sum order
    for theta in (10000.0, 1e6):
        for half in (8, 32, 64):
            want = np.asarray(theta ** (-jnp.arange(0, half,
                                                    dtype=jnp.float32)
                                        / half))
            assert np.array_equal(t_layers.rope_freqs(half, theta), want)
    xr = rs.randn(2, 50, 3, 16).astype(np.float32)
    pos = np.tile(np.arange(50), (2, 1))
    _close(t_layers.rope(torch.from_numpy(xr), torch.from_numpy(pos)),
           j_layers.rope(jnp.asarray(xr), jnp.asarray(pos)),
           rtol=1e-6, atol=1e-6)
    kv = rs.randn(2, 5, 3, 4).astype(np.float32)
    assert np.array_equal(
        t_attention._repeat_kv(torch.from_numpy(kv), 3).numpy(),
        np.asarray(j_attention._repeat_kv(jnp.asarray(kv), 3)))


def test_cim_linear_bit_for_bit_where_the_product_is_exact():
    """Small-integer inputs and weights whose per-column scale is a power
    of two: the f32 product is exact in any order, so the NLQ codes and
    the output are equal bit for bit."""
    rs = np.random.RandomState(2)
    x = rs.randint(-4, 5, (26, 64)).astype(np.float32)
    w_int = rs.randint(-3, 4, (64, 48)).astype(np.float32)
    w_int[0] = 3.0                          # max |w| = 3 * 2^-5 a column
    w = w_int * np.float32(2.0 ** -5)
    b = (rs.randint(-8, 9, 48) * 2.0 ** -3).astype(np.float32)
    for p_np in ({"w": w}, {"w": w, "b": b}):
        want = np.asarray(j_layers.cim_linear(
            {k: jnp.asarray(a) for k, a in p_np.items()}, jnp.asarray(x)))
        got = t_layers.cim_linear(
            {k: torch.from_numpy(a) for k, a in p_np.items()},
            torch.from_numpy(x)).numpy()
        assert np.array_equal(got, want)
        assert len(np.unique(got)) > 8


# --- the model ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc)
    toks = _tokens(np.random.RandomState(1), jc.vocab_size, (2, 13))
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks).long()
    want, _ = j_lm.forward(jp, {"tokens": jt}, jc)
    got, aux = t_lm.forward(tp, {"tokens": tt}, tc)
    assert got.shape == (2, 13, tc.padded_vocab) and float(aux) == 0.0
    _close(got, want)
    want, _, jcache = j_lm.forward(jp, {"tokens": jt}, jc, prefill=True)
    got, _, tcache = t_lm.forward(tp, {"tokens": tt}, tc, prefill=True)
    assert got.shape == (2, tc.padded_vocab)
    _close(got, want)
    assert set(tcache) == set(jcache)
    for name in jcache:
        for key in ("k", "v"):
            assert tuple(tcache[name][key].shape) == jcache[name][key].shape
            _close(tcache[name][key], jcache[name][key])


@pytest.mark.parametrize("arch", ARCHS)
def test_pad_cache_and_decode_match_reference(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc)
    rs = np.random.RandomState(2)
    toks = _tokens(rs, jc.vocab_size, (2, 9))
    _, _, jcache = j_lm.forward(jp, {"tokens": jnp.asarray(toks)}, jc,
                                prefill=True)
    _, _, tcache = t_lm.forward(tp, {"tokens": torch.from_numpy(toks).long()},
                                tc, prefill=True)
    jcache, tcache = j_lm.pad_cache(jcache, jc, 20), \
        t_lm.pad_cache(tcache, tc, 20)
    for key in ("k", "v"):
        assert tuple(tcache["b0"][key].shape) == jcache["b0"][key].shape
        _close(tcache["b0"][key], jcache["b0"][key])
    pos = np.full((2,), 9, np.int32)
    for t in range(8):
        nt = _tokens(rs, jc.vocab_size, (2, 1))
        want, jcache = j_lm.decode_step(jp, jcache, jnp.asarray(nt),
                                        jnp.asarray(pos + t), jc)
        got, tcache = t_lm.decode_step(tp, tcache, torch.from_numpy(nt).long(),
                                       torch.from_numpy(pos + t).long(), tc)
        assert got.shape == (2, tc.padded_vocab)
        _close(got, want)
    for key in ("k", "v"):
        _close(tcache["b0"][key], jcache["b0"][key])


def test_tail_blocks_and_teacher_forced_decode_equal_prefill():
    """A pattern of two blocks over five layers (two groups and a tail
    block) against the reference, and the port's prefill logits against
    its own teacher-forced decode from an empty cache."""
    jc, tc = _cfgs("qwen2.5-32b", pattern=("attn", "attn"), n_layers=5)
    assert tc.n_groups == 2 and tc.tail_pattern == ("attn",)
    jp, tp = _params(jc, seed=3)
    toks = _tokens(np.random.RandomState(4), jc.vocab_size, (1, 8))
    want, _, jcache = j_lm.forward(jp, {"tokens": jnp.asarray(toks)}, jc,
                                   prefill=True)
    got, _, tcache = t_lm.forward(tp, {"tokens": torch.from_numpy(toks).long()},
                                  tc, prefill=True)
    _close(got, want)
    assert set(tcache) == {"b0", "b1", "tail0"}
    _close(tcache["tail0"]["k"], jcache["tail0"]["k"])
    cache = t_lm.init_cache(tc, 1, 8, device="cpu")
    assert tuple(cache["b1"]["k"].shape) == (2, 1, 8, tc.n_kv, tc.hd)
    for t in range(8):
        step, cache = t_lm.decode_step(
            tp, cache, torch.from_numpy(toks[:, t:t + 1]).long(),
            torch.full((1,), t), tc)
    _close(step, got.numpy())
    for name in tcache:
        _close(cache[name]["v"], tcache[name]["v"].numpy())


@pytest.mark.parametrize("kw", [dict(cim_linear=True), dict(kwn_ffn_k=8)],
                         ids=["cim_linear", "kwn_ffn_k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cim_and_kwn_ffn_forwards_match_reference(arch, kw):
    """The CIM FFN quantises its products through the NLQ ramp, whose
    codes could flip where the two sides' sum orders straddle a boundary;
    none does on these draws, so the logits hold at the f32 tolerance."""
    jc, tc = _cfgs(arch, **kw)
    jp, tp = _params(jc)
    toks = _tokens(np.random.RandomState(5), jc.vocab_size, (2, 11))
    want, _ = j_lm.forward(jp, {"tokens": jnp.asarray(toks)}, jc)
    got, _ = t_lm.forward(tp, {"tokens": torch.from_numpy(toks).long()}, tc)
    _close(got, want)


# --- serving ---------------------------------------------------------------------

def _first_divergence_is_near_tie(tp, tc, prompt, port, ref) -> bool:
    """Whether the first token where two greedy runs part was a near tie:
    the top-2 gap of the port's logits there (batch 1, teacher forced) is
    within twice the tolerance (each side may sit that far off)."""
    i = next(i for i, (a, b) in enumerate(zip(port, ref)) if a != b)
    ctx = list(prompt) + list(port[:i])
    cache = t_lm.init_cache(tc, 1, len(ctx) + 1, device="cpu")
    for t, tok in enumerate(ctx):
        logits, cache = t_lm.decode_step(tp, cache, torch.tensor([[tok]]),
                                         torch.tensor([t]), tc)
    top2 = torch.topk(logits[0, :tc.vocab_size], 2).values
    return float(top2[0] - top2[1]) <= TOL["atol"] * 2


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_engine_greedy_tokens_match_reference(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, seed=6)
    rs = np.random.RandomState(7)
    prompts = [[int(t) for t in _tokens(rs, jc.vocab_size, 3 + u % 3)]
               for u in range(6)]
    j_eng = j_engine.BatchedEngine(jc, jax.tree.map(jnp.asarray, jp),
                                   batch_slots=4, s_max=32)
    t_eng = t_engine.BatchedEngine(tc, tp, batch_slots=4, s_max=32,
                                   device="cpu")
    for eng, req in ((j_eng, j_engine.Request), (t_eng, t_engine.Request)):
        for uid, prompt in enumerate(prompts):
            eng.submit(req(uid=uid, prompt=prompt, max_new_tokens=6))
    j_done = {r.uid: r.generated for r in j_eng.run(max_rounds=64)}
    t_done = {r.uid: r.generated for r in t_eng.run(max_rounds=64)}
    assert sorted(t_done) == sorted(j_done) == list(range(6))
    near_ties = 0
    for uid, prompt in enumerate(prompts):
        assert len(t_done[uid]) == 6
        if t_done[uid] != j_done[uid]:
            assert _first_divergence_is_near_tie(tp, tc, prompt,
                                                 t_done[uid], j_done[uid])
            near_ties += 1
    assert near_ties <= 1


def test_batched_engine_budget_and_sampling():
    """``max_rounds`` budgets decode rounds only, as in the reference; at
    temperature > 0 the serve step draws from the generator it is given."""
    _, tc = _cfgs("smollm-135m")
    _, tp = _params(_cfgs("smollm-135m")[0])
    eng = t_engine.BatchedEngine(tc, tp, batch_slots=2, s_max=16,
                                 device="cpu")
    for uid in range(3):
        eng.submit(t_engine.Request(uid=uid, prompt=[1, 2, 3],
                                    max_new_tokens=5))
    assert eng.run(max_rounds=3) == [] and eng.pending
    done = eng.run(max_rounds=64)
    assert sorted(r.uid for r in done) == [0, 1, 2]
    # s_max caps a request: the position reaches s_max - 1
    eng = t_engine.BatchedEngine(tc, tp, batch_slots=1, s_max=8,
                                 device="cpu")
    eng.submit(t_engine.Request(uid=0, prompt=[4, 5, 6], max_new_tokens=20))
    assert len(eng.run()[0].generated) == 4
    step = t_engine.build_serve_step(tc, temperature=1.5)
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        cache = t_lm.init_cache(tc, 2, 16, device="cpu")
        toks = torch.tensor([[1], [2]])
        drawn = []
        for t in range(8):
            toks, logits, cache = step(tp, cache, toks,
                                       torch.full((2,), t), gen)
            drawn.append(toks[:, 0].tolist())
        runs.append(drawn)
    assert runs[0] == runs[1]
    assert logits.shape == (2, tc.vocab_size)
    assert all(0 <= t < tc.vocab_size for row in runs[0] for t in row)
    greedy = t_engine.build_serve_step(tc)(
        tp, t_lm.init_cache(tc, 2, 16, device="cpu"), torch.tensor([[1], [2]]),
        torch.zeros(2, dtype=torch.long), None)[0]
    assert greedy.dtype == torch.int32 and greedy.shape == (2, 1)


@pytest.mark.parametrize("prompt_len", [7, 8, 9])
def test_batched_engine_at_s_max_matches_reference(prompt_len):
    """Prompts of ``s_max - 1``, ``s_max`` and ``s_max + 1`` tokens: the
    reference's one-hot cache write is all zeros at ``pos >= s_max``, so
    nothing is written and decoding goes on; the port gives its tokens."""
    jc, tc = _cfgs("smollm-135m")
    jp, tp = _params(jc, seed=1)
    prompt = [int(t) for t in _tokens(np.random.RandomState(prompt_len),
                                      jc.vocab_size, prompt_len)]
    j_eng = j_engine.BatchedEngine(jc, jax.tree.map(jnp.asarray, jp),
                                   batch_slots=1, s_max=8)
    t_eng = t_engine.BatchedEngine(tc, tp, batch_slots=1, s_max=8,
                                   device="cpu")
    for eng, req in ((j_eng, j_engine.Request), (t_eng, t_engine.Request)):
        eng.submit(req(uid=0, prompt=prompt, max_new_tokens=4))
    want = [r.generated for r in j_eng.run()]
    got = [r.generated for r in t_eng.run()]
    assert got == want and len(got) == 1 and got[0]


def test_mha_decode_past_s_max_matches_reference():
    """``mha_decode`` with one row at ``pos = s_max`` and one inside: the
    output and the cache equal the reference's (the row past the end
    writes nothing and sees every slot)."""
    jc, _ = _cfgs("smollm-135m")
    rs = np.random.RandomState(4)
    s_max, hd, d = 8, jc.hd, jc.d_model
    widths = dict(wq=jc.n_heads * hd, wk=jc.n_kv * hd, wv=jc.n_kv * hd)
    p = {name: {"w": (rs.randn(d, n) / np.sqrt(d)).astype(np.float32)}
         for name, n in widths.items()}
    p["wo"] = {"w": (rs.randn(jc.n_heads * hd, d) / np.sqrt(d))
               .astype(np.float32)}
    x = rs.randn(2, 1, d).astype(np.float32)
    k, v = (rs.randn(2, s_max, jc.n_kv, hd).astype(np.float32)
            for _ in range(2))
    pos = np.array([s_max, 3], np.int32)
    kw = dict(n_heads=jc.n_heads, n_kv=jc.n_kv, head_dim=hd,
              rope_theta=jc.rope_theta)
    want, jcache = j_attention.mha_decode(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        j_attention.KVCache(jnp.asarray(k), jnp.asarray(v)),
        jnp.asarray(pos), **kw)
    got, tcache = t_attention.mha_decode(
        jax.tree.map(torch.from_numpy, p), torch.from_numpy(x),
        t_attention.KVCache(torch.from_numpy(k.copy()),
                            torch.from_numpy(v.copy())),
        torch.from_numpy(pos).long(), **kw)
    _close(got, want)
    _close(tcache.k, jcache.k)
    _close(tcache.v, jcache.v)
    np.testing.assert_array_equal(tcache.k[0].numpy(), k[0])
    np.testing.assert_array_equal(tcache.v[0].numpy(), v[0])


@pytest.mark.parametrize("cim", [False, True], ids=["dense", "cim"])
def test_launch_serve_smoke_on_cpu(cim, capsys):
    argv = ["--smoke", "--device", "cpu"] + (["--cim"] if cim else [])
    done = t_serve.main(argv)
    assert len(done) == 8
    assert all(len(r.generated) == 12 for r in done)
    assert sorted(len(r.prompt) for r in done) == [4, 4, 5, 5, 6, 6, 7, 7]
    vocab = t_base.reduced(t_configs.ARCHS["smollm-135m"]).vocab_size
    assert all(0 <= t < vocab for r in done for t in r.generated)
    assert f"cim_mode={cim}" in capsys.readouterr().out


# --- what both packages refuse -----------------------------------------------

def _refusal_decode_step(jc, tc):
    jp, tp = _params(jc)
    jcache = j_lm.init_cache(jc, 1, 8)
    tcache = t_lm.init_cache(tc, 1, 8, device="cpu")
    return (lambda: j_lm.decode_step(jp, jcache, jnp.zeros((1, 1), jnp.int32),
                                     jnp.zeros((1,), jnp.int32), jc),
            lambda: t_lm.decode_step(tp, tcache,
                                     torch.zeros((1, 1), dtype=torch.long),
                                     torch.zeros(1, dtype=torch.long), tc))


def _refusal_engine(jc, tc):
    jp, tp = _params(jc)

    def run(eng, req):
        eng.submit(req(uid=0, prompt=[1, 2], max_new_tokens=2))
        return eng.run()

    return (lambda: run(j_engine.BatchedEngine(
                jc, jax.tree.map(jnp.asarray, jp), batch_slots=1, s_max=8),
                j_engine.Request),
            lambda: run(t_engine.BatchedEngine(tc, tp, batch_slots=1,
                                               s_max=8, device="cpu"),
                        t_engine.Request))


def _refusal_launch_serve(jc, tc):
    argv = ["--smoke", "--arch", tc.name, "--requests", "1", "--max-new",
            "1"]
    return (lambda: j_serve.main(argv),
            lambda: t_serve.main(argv + ["--device", "cpu"]))


# encoder-only models have no decode step: the reference asserts, the port
# raises ValueError, through decode_step, BatchedEngine and launch.serve
UNSUPPORTED = {
    "audio_encoder_only_decode_step": ("hubert-xlarge", {},
                                       _refusal_decode_step),
    "audio_encoder_only_engine": ("hubert-xlarge", {}, _refusal_engine),
    "audio_encoder_only_launch_serve": ("hubert-xlarge", {},
                                        _refusal_launch_serve),
    "encoder_only_decode_step": ("smollm-135m", dict(encoder_only=True),
                                 _refusal_decode_step),
    "encoder_only_engine": ("smollm-135m", dict(encoder_only=True),
                            _refusal_engine),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_configs_raise(case):
    """What both packages refuse: a decode step on an encoder-only model,
    called directly, through ``BatchedEngine`` and through
    ``launch.serve`` (hubert-xlarge, and smollm-135m with
    ``encoder_only=True``).  Each case shows both raise."""
    arch, kw, calls = UNSUPPORTED[case]
    jc, tc = _cfgs(arch, **kw)
    reference, port = calls(jc, tc)
    with pytest.raises(AssertionError, match="encoder-only"):
        reference()
    with pytest.raises(ValueError, match="encoder-only"):
        port()
