"""The local/global attention, xLSTM and RG-LRU families and the int8 /
int4 KV cache against the JAX package on the CPU: reduced gemma2-2b,
recurrentgemma-9b and xlstm-350m (window 32), the full forward, prefill
at two windows, ``pad_cache``, decode and ``BatchedEngine``; the int8 and
int4 caches on gemma2 and smollm.

Parameters come from the reference's ``materialize`` and cross over as
numpy arrays (``convert.lm_params_from_jax``); tokens come from
``numpy.random.RandomState``.  Everything runs in f32 (``reduced()`` sets
it) and is held at rtol = atol = 1e-5, as ``test_torch_lm.py`` states.
Two measured exceptions:

* xlstm-350m's mLSTM divides by a normaliser that cancels, so the
  reference itself moves further than 1e-5 when its inputs move by one
  ULP (``test_torch_recurrent.py``).  Its logits are held within four
  times the reference's own change under a one-ULP perturbation of the
  embedding table, never looser than 1e-5.
* A quantized cache rounds each K/V value to a code, and the reference
  takes the dequantized attention products in bf16 (whatever the
  config's dtype).  Where the two sides' f32 values straddle a half-way
  point by an ULP, a code differs by one or a bf16 result by one ULP,
  which moves the logits by 1e-4 to 1e-3.  Every decode step starts from
  the reference's cache; a code that differs must differ by one, every
  step's logits are held at the JAX suite's 2e-3, and six of the eight
  at 1e-5 (the quantized products themselves are bit for bit on the same
  operands in ``test_torch_kvq.py``).

The reference faults pinned: prefill over a prompt no longer than the
window, then decode, raises in both packages (the reference a
``KeyError``, the port a ``ValueError`` that names the case); and the
engine's admission steps every slot's recurrent state with each prompt
token, so a request's tokens depend on what else is in the batch, in the
port as in the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.configs import base as j_base
from repro.models import lm as j_lm
from repro.nn import module as j_module
from repro.serve import engine as j_engine
from repro_torch import configs as t_configs
from repro_torch.configs import base as t_base
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve as t_serve
from repro_torch.models import lm as t_lm
from repro_torch.nn import module as t_module
from repro_torch.serve import engine as t_engine

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
FAMILIES = ("gemma2-2b", "recurrentgemma-9b", "xlstm-350m")
WINDOW = 32                        # reduced()'s window
PREFILL = 2 * WINDOW
F32_TOL = 2e-3                     # prefill against decode: the JAX suite's


def _cfgs(arch, **kw):
    return (dataclasses.replace(j_base.reduced(j_configs.ARCHS[arch]), **kw),
            dataclasses.replace(t_base.reduced(t_configs.ARCHS[arch]), **kw))


def _params(jc, seed=0):
    jp = jax.tree.map(np.asarray, j_module.materialize(
        j_lm.param_specs(jc), jax.random.PRNGKey(seed)))
    return jp, lm_params_from_jax(jp, device="cpu")


def _tokens(rs, vocab, shape):
    return rs.randint(0, vocab, shape).astype(np.int32)


def _close(got: torch.Tensor, want, tol=None):
    tol = tol or TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _tol(jc, jp, run) -> dict:
    """TOL, or for a configuration with mLSTM blocks four times the
    reference's own change when its embedding table moves by one ULP
    (``run(params)`` gives the reference's output)."""
    if "mlstm" not in jc.pattern:
        return TOL
    rs = np.random.RandomState(99)
    table = jp["embed"]["table"]
    moved = dict(jp, embed={"table": np.nextafter(table, np.where(
        rs.rand(*table.shape) < 0.5, np.inf, -np.inf).astype(np.float32))})
    noise = float(np.abs(np.asarray(run(moved)) - np.asarray(run(jp))).max())
    tol = max(TOL["atol"], 4 * noise)
    return dict(rtol=tol, atol=tol)


def _cache_close(tcache, jcache, tol):
    assert set(tcache) == set(jcache)
    for name in jcache:
        assert set(tcache[name]) == set(jcache[name]), name
        for key, want in jcache[name].items():
            got, want = tcache[name][key], np.asarray(want)
            assert tuple(got.shape) == want.shape, (name, key)
            assert got.numpy().dtype == want.dtype, (name, key)
            if key == "slot_pos":
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                scale = max(1.0, float(np.abs(want).max()))
                np.testing.assert_allclose(got.numpy(), want,
                                           rtol=tol["rtol"],
                                           atol=tol["atol"] * scale)


def _to_torch(cache) -> dict:
    return {name: {key: torch.from_numpy(np.array(t))
                   for key, t in entry.items()}
            for name, entry in cache.items()}


# --- configs and caches -----------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_param_count_and_layout_equal_reference(arch):
    jc, tc = j_configs.ARCHS[arch], t_configs.ARCHS[arch]
    assert tc.param_count() == jc.param_count()
    jc, tc = _cfgs(arch)
    jp, _ = _params(jc)
    tp = t_module.materialize(t_lm.param_specs(tc),
                              torch.Generator().manual_seed(0), device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(t_module.leaves(tp)) == len(flat)
    for path, a in flat:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == a.shape, path


@pytest.mark.parametrize("kv_quant", [None, "int8", "int4"])
@pytest.mark.parametrize("arch", FAMILIES + ("smollm-135m",))
def test_init_cache_equals_reference(arch, kv_quant):
    jc, tc = _cfgs(arch, kv_quant=kv_quant)
    for s_max in (16, 48):
        jcache = j_lm.init_cache(jc, 2, s_max)
        tcache = t_lm.init_cache(tc, 2, s_max, device="cpu")
        assert set(tcache) == set(jcache)
        for name, entry in jcache.items():
            assert set(tcache[name]) == set(entry)
            for key, want in entry.items():
                got = tcache[name][key]
                assert got.numpy().dtype == np.asarray(want).dtype
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- forward, prefill, decode -------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_and_prefill_match_reference(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc)
    toks = _tokens(np.random.RandomState(1), jc.vocab_size, (2, PREFILL))
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks).long()
    tol = _tol(jc, jp, lambda p: j_lm.forward(p, {"tokens": jt}, jc)[0])
    want, _ = j_lm.forward(jp, {"tokens": jt}, jc)
    got, aux = t_lm.forward(tp, {"tokens": tt}, tc)
    assert got.shape == (2, PREFILL, tc.padded_vocab) and float(aux) == 0.0
    _close(got, want, tol)
    want, _, jcache = j_lm.forward(jp, {"tokens": jt}, jc, prefill=True)
    got, _, tcache = t_lm.forward(tp, {"tokens": tt}, tc, prefill=True)
    assert got.shape == (2, tc.padded_vocab)
    _close(got, want, tol)
    _cache_close(tcache, jcache, tol)
    if arch != "xlstm-350m":
        ring = tcache["b0" if arch == "gemma2-2b" else "b2"]
        assert tuple(ring["slot_pos"].shape) == (tc.n_groups, 2, WINDOW)


@pytest.mark.parametrize("arch", FAMILIES)
def test_pad_cache_and_decode_match_reference(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, seed=2)
    rs = np.random.RandomState(2)
    toks = _tokens(rs, jc.vocab_size, (2, PREFILL))
    _, _, jcache = j_lm.forward(jp, {"tokens": jnp.asarray(toks)}, jc,
                                prefill=True)
    _, _, tcache = t_lm.forward(tp, {"tokens": torch.from_numpy(toks).long()},
                                tc, prefill=True)
    s_max = PREFILL + 16
    jcache = j_lm.pad_cache(jcache, jc, s_max)
    tcache = t_lm.pad_cache(tcache, tc, s_max)
    steps = [_tokens(rs, jc.vocab_size, (2, 1)) for _ in range(8)]

    def run(p):
        cache, out = j_lm.pad_cache(j_lm.forward(
            p, {"tokens": jnp.asarray(toks)}, jc, prefill=True)[2], jc,
            s_max), []
        for t, nt in enumerate(steps):
            logits, cache = j_lm.decode_step(
                p, cache, jnp.asarray(nt),
                jnp.full((2,), PREFILL + t, jnp.int32), jc)
            out.append(logits)
        return jnp.stack(out)

    tol = _tol(jc, jp, run)
    _cache_close(tcache, jcache, tol)
    for t, nt in enumerate(steps):
        pos = np.full((2,), PREFILL + t, np.int32)
        want, jcache = j_lm.decode_step(jp, jcache, jnp.asarray(nt),
                                        jnp.asarray(pos), jc)
        got, tcache = t_lm.decode_step(tp, tcache,
                                       torch.from_numpy(nt).long(),
                                       torch.from_numpy(pos).long(), tc)
        assert got.shape == (2, tc.padded_vocab)
        _close(got, want, tol)
    _cache_close(tcache, jcache, tol)


@pytest.mark.parametrize("arch", FAMILIES)
def test_teacher_forced_decode_equals_prefill(arch):
    """The port's prefill against its own token-by-token decode from
    ``init_cache`` (the engine's path), at the JAX suite's 2e-3; the
    caches too where both hold the same thing (recurrent states, and a
    ring over a prompt longer than its window)."""
    _, tc = _cfgs(arch)
    _, tp = _params(_cfgs(arch)[0], seed=3)
    toks = torch.from_numpy(_tokens(np.random.RandomState(3), tc.vocab_size,
                                    (2, PREFILL))).long()
    want, _, pcache = t_lm.forward(tp, {"tokens": toks}, tc, prefill=True)
    cache = t_lm.init_cache(tc, 2, PREFILL, device="cpu")
    for t in range(PREFILL):
        got, cache = t_lm.decode_step(tp, cache, toks[:, t:t + 1],
                                      torch.full((2,), t), tc)
    _close(got, want.numpy(), dict(rtol=F32_TOL, atol=F32_TOL))
    for name, entry in pcache.items():
        for key, t in entry.items():
            if key == "slot_pos":
                np.testing.assert_array_equal(cache[name][key].numpy(),
                                              t.numpy())
            else:
                _close(cache[name][key], t.numpy(),
                       dict(rtol=F32_TOL, atol=F32_TOL))


# --- the quantized cache ------------------------------------------------------------

def _codes(t: np.ndarray, mode: str) -> np.ndarray:
    if mode == "int8":
        return t.astype(np.int32)
    return np.stack([(t & 0xF).astype(np.int32), (t >> 4).astype(np.int32)])


def _flips(tcache, jcache, mode) -> int:
    """Codes that differ between the two caches' payloads; each must
    differ by one (an f32 value an ULP either side of a half-way point)."""
    n = 0
    for name, entry in jcache.items():
        for key in ("k", "v"):
            if "k_scale" not in entry:
                continue
            d = np.abs(_codes(tcache[name][key].numpy(), mode)
                       - _codes(np.asarray(entry[key]), mode))
            assert d.max() <= 1, (name, key, int(d.max()))
            n += int((d != 0).sum())
        for key in ("k_scale", "v_scale"):
            if key in entry:
                _close(tcache[name][key], entry[key])
    return n


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("arch", ["gemma2-2b", "smollm-135m"])
def test_quantized_cache_prefill_and_decode_match_reference(arch, mode):
    jc, tc = _cfgs(arch, kv_quant=mode)
    jp, tp = _params(jc, seed=4)
    rs = np.random.RandomState(4)
    toks = _tokens(rs, jc.vocab_size, (2, PREFILL))
    want, _, jcache = j_lm.forward(jp, {"tokens": jnp.asarray(toks)}, jc,
                                   prefill=True)
    got, _, tcache = t_lm.forward(tp, {"tokens": torch.from_numpy(toks)
                                       .long()}, tc, prefill=True)
    _close(got, want)
    n_codes = sum(np.asarray(e[k]).size for e in jcache.values()
                  if "k_scale" in e for k in ("k", "v"))
    assert _flips(tcache, jcache, mode) <= max(2, n_codes // 1000)
    s_max = PREFILL + 16
    jcache = j_lm.pad_cache(jcache, jc, s_max)
    assert t_lm.pad_cache(tcache, tc, s_max)[
        "b1" if arch == "gemma2-2b" else "b0"]["k"].shape[-3] == s_max
    held = 0
    for t in range(8):
        nt = _tokens(rs, jc.vocab_size, (2, 1))
        pos = np.full((2,), PREFILL + t, np.int32)
        tcache = _to_torch(jcache)
        want, jcache = j_lm.decode_step(jp, jcache, jnp.asarray(nt),
                                        jnp.asarray(pos), jc)
        got, tcache = t_lm.decode_step(tp, tcache,
                                       torch.from_numpy(nt).long(),
                                       torch.from_numpy(pos).long(), tc)
        _flips(tcache, jcache, mode)
        _close(got, want, dict(rtol=F32_TOL, atol=F32_TOL))
        held += bool(np.allclose(got.numpy(), np.asarray(want), **TOL))
    assert held >= 6, held


def test_optimized_serving_reaches_the_int8_cache():
    for arch in FAMILIES + ("smollm-135m",):
        cfg = t_base.optimized(t_configs.ARCHS[arch], serving=True)
        assert cfg.kv_quant == "int8"
    tc = t_base.optimized(t_base.reduced(t_configs.ARCHS["gemma2-2b"]),
                          serving=True)
    cache = t_lm.init_cache(tc, 1, 8, device="cpu")
    assert cache["b1"]["k"].dtype == torch.int8          # global: int8
    assert cache["b0"]["k"].dtype == torch.float32       # local: a ring
    _, tp = _params(_cfgs("gemma2-2b")[0])
    logits, _ = t_lm.decode_step(tp, cache, torch.tensor([[3]]),
                                 torch.tensor([0]), tc)
    assert bool(torch.isfinite(logits).all())


# --- where the reference fails ------------------------------------------------------

@pytest.mark.parametrize("s", [16, WINDOW])
@pytest.mark.parametrize("arch", ["gemma2-2b", "recurrentgemma-9b"])
def test_prefill_within_a_window_then_decode_raises_in_both(arch, s):
    """Prefill over at most a window leaves a local layer's cache without
    ``slot_pos``: the reference's decode raises ``KeyError``, the port's a
    ``ValueError`` that says so (it builds no ring of its own)."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc)
    toks = _tokens(np.random.RandomState(5), jc.vocab_size, (1, s))
    _, _, jcache = j_lm.forward(jp, {"tokens": jnp.asarray(toks)}, jc,
                                prefill=True)
    _, _, tcache = t_lm.forward(tp, {"tokens": torch.from_numpy(toks)
                                     .long()}, tc, prefill=True)
    jcache, tcache = (j_lm.pad_cache(jcache, jc, s + 4),
                      t_lm.pad_cache(tcache, tc, s + 4))
    with pytest.raises(KeyError, match="slot_pos"):
        j_lm.decode_step(jp, jcache, jnp.zeros((1, 1), jnp.int32),
                         jnp.full((1,), s, jnp.int32), jc)
    with pytest.raises(ValueError, match="no longer than the window"):
        t_lm.decode_step(tp, tcache, torch.zeros((1, 1), dtype=torch.long),
                         torch.full((1,), s), tc)


# --- serving --------------------------------------------------------------------------

def _engines(arch, submissions, slots, seed, s_max=32, new=4):
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, seed=seed)
    out = []
    for eng, req in ((j_engine.BatchedEngine(jc, jax.tree.map(jnp.asarray, jp),
                                             batch_slots=slots, s_max=s_max),
                      j_engine.Request),
                     (t_engine.BatchedEngine(tc, tp, batch_slots=slots,
                                             s_max=s_max, device="cpu"),
                      t_engine.Request)):
        for uid, prompt in enumerate(submissions):
            eng.submit(req(uid=uid, prompt=prompt, max_new_tokens=new))
        out.append({r.uid: r.generated for r in eng.run(max_rounds=64)})
    return out, tc, tp


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-350m",
                                  "gemma2-2b"])
def test_engine_tokens_equal_reference_alone_and_paired(arch):
    """The same prompt alone and beside another: the port's tokens are
    the reference's in both cases.  For the recurrent configurations the
    two differ, in both packages: each prompt token of one request steps
    the other slot's recurrent state too (the reference's admission)."""
    prompt, other = [1, 2, 3], [5, 6, 7, 8]
    (j_alone, t_alone), _, _ = _engines(arch, [prompt], 2, seed=6)
    (j_pair, t_pair), _, _ = _engines(arch, [prompt, other], 2, seed=6)
    assert t_alone == j_alone and t_pair == j_pair
    assert len(t_pair[0]) == len(t_pair[1]) == 4
    recurrent = arch != "gemma2-2b"
    assert (t_alone[0] != t_pair[0]) == recurrent


@pytest.mark.parametrize("arch", FAMILIES)
def test_batched_engine_greedy_tokens_match_reference(arch):
    """Six requests of 3-5 tokens through four slots (two admitted as
    slots free), 6 new tokens each: the reference's tokens."""
    rs = np.random.RandomState(7)
    vocab = _cfgs(arch)[1].vocab_size
    prompts = [[int(t) for t in _tokens(rs, vocab, 3 + u % 3)]
               for u in range(6)]
    (j_done, t_done), _, _ = _engines(arch, prompts, 4, seed=7, new=6)
    assert sorted(t_done) == sorted(j_done) == list(range(6))
    assert t_done == j_done
    assert all(len(t) == 6 for t in t_done.values())


@pytest.mark.parametrize("arch", FAMILIES)
def test_launch_serve_smoke_on_cpu(arch, capsys):
    done = t_serve.main(["--smoke", "--device", "cpu", "--arch", arch,
                         "--requests", "4", "--max-new", "5"])
    assert len(done) == 4 and all(len(r.generated) == 5 for r in done)
    vocab = t_base.reduced(t_configs.ARCHS[arch]).vocab_size
    assert all(0 <= t < vocab for r in done for t in r.generated)
    assert "completed 4/4" in capsys.readouterr().out
