"""The partitioned mesh step against the reference's.

Each rank computes its share: its rows of the batch (over "data"), its
heads, FFN units and vocabulary (over "model", Megatron's column- and
row-parallel products), its block of the sequence where the config's
overrides put it over "model" and it divides (Megatron sequence
parallelism: the residual stream between the blocks is the rank's
block, the tokens come cut as ``batch_axes`` lays them out), its block
of the decode cache (rows over "data", slots over "model", split-KV),
FSDP's leaves gathered block by block.

The reference side runs in one subprocess on 8 simulated host devices, a
(2, 4) ("data", "model") mesh: its own ``lm.forward`` / ``loss_fn`` /
``decode_step`` jitted with ``in_shardings`` from ``module.shardings``
and ``shardings_like`` of ``batch_axes`` / ``cache_axes``, one AdamW
update on its gradients, and its ``BatchedEngine`` over the mesh
(``tests/_dist_reference_jax.py OUT part``).  The port's runs beside it
in another subprocess on 8 gloo ranks (``tests/_dist_ranks_torch.py
part``), each rank on its share, the results gathered whole.  Both draw
the same operands from ``numpy.random.RandomState``
(``_dist_cases.part_inputs``), for reduced qwen2.5-32b, smollm-135m,
gemma2-2b, kimi-k2 and recurrentgemma-9b (its RG-LRU on 16 of 64
channels a rank), qwen2.5 with 6 heads (whose q block over "model" cuts
a head, as qwen2.5's 40 over 16), qwen2.5 with the int8 KV cache,
arctic-480b, internvl2-26b (4 patches before 8 tokens), qwen2.5 on 6
positions (which do not divide over "model": the sequence stays whole),
xlstm-350m (its mLSTM and sLSTM cells one head a rank) and xlstm with 3
heads (which do not divide over "model": the cells run whole):

* logits, the aux loss and the loss within rtol / atol 1e-5, every
  gradient leaf within 1e-4, one AdamW step's parameters within 1e-5
  (xlstm's logits, gradient leaves and gradient norm, prefill and decode
  within four times the reference's own change when its embedding table
  moves by one ULP, and never tighter than those: its mLSTM divides by
  a normaliser that cancels, so the reference's own sharded and
  unsharded steps differ by more than 1e-5, the rule of
  ``test_torch_lm_families.py`` and ``test_torch_lm_train.py``);
* a prefill and three decode steps within 1e-5 (the int8 cache's
  decode within two bf16 ULPs of the largest logit), the cache's slots
  split over "model"; ``BatchedEngine``'s tokens equal;
* each rank held its rows only, and a train step on one rank of reduced
  qwen2.5 or recurrentgemma counts at most 1.2 x the world-1 count / 8
  FLOPs;
* recurrentgemma's RG-LRU scans and keeps in its cache the rank's block
  of the channels, and its decode step gathers no recurrent state;
* the residual stream between the blocks, and the tokens, are each
  rank's block of the sequence where the reference's ``partition_spec``
  cuts ("batch", "seq", None), whole elsewhere.

In process: ``lm.cache_axes`` equal to the reference's for every
registry config, and the blocks of a batch and of a cache
(``module.blocks_like``, ``lm.init_cache(mesh=)``) equal the blocks of
the reference's ``partition_spec``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.configs import base as j_base
from repro.models import lm as j_lm
from repro.nn import module as j_module
from repro_torch import configs as t_configs
from repro_torch.configs import base as t_base
from repro_torch.models import lm as t_lm
from repro_torch.nn import module as t_module

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _dist_cases as C  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("part")
    ref, port = d / "ref.npz", d / "port.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, *map(str, args)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for args in ([ROOT / "tests" / "_dist_reference_jax.py", ref,
                      "part"],
                     [ROOT / "tests" / "_dist_ranks_torch.py", "part", "-",
                      port])]
    try:
        for p in procs:
            _, err = p.communicate(timeout=400)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    with np.load(ref) as r, np.load(port) as t:
        yield dict(r), dict(t)


def _tol(want, tag: str, key: str, tol=TOL) -> dict:
    """``tol``, or for a config with mLSTM blocks four times the
    reference's own change of ``key`` under a one-ULP move of its
    embedding table (``_dist_reference_jax.part_results``'s
    ``noise/...``), where that is looser."""
    noise = want.get(f"{tag}/noise/{key}")
    if noise is None:
        return tol
    t = max(tol["atol"], 4 * float(noise))
    return dict(rtol=t, atol=t)


def _cfg(tag: str):
    return C.part_config(tag, t_configs.ARCHS, t_base.reduced)


def _keys(want, arch, part):
    return [k for k in want if k.startswith(f"out/part/{arch}/{part}")]


@pytest.mark.parametrize("arch", C.PART_ARCHS)
def test_forward_matches_reference_partitioned(results, arch):
    want, got = results
    tag = f"out/part/{arch}"
    for key in ("logits", "aux"):
        k = f"{tag}/{key}"
        np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                   **_tol(want, tag, key))
    # each rank computed its rows of the batch only
    assert int(got[f"out/part/{arch}/rows"]) == C.PART_B // 2


@pytest.mark.parametrize("arch", C.PART_ARCHS)
def test_loss_and_gradients_match_reference_partitioned(results, arch):
    want, got = results
    for key in ("loss", "ce"):
        k = f"out/part/{arch}/{key}"
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    keys = _keys(want, arch, "grads/")
    assert len(keys) == len(t_module.leaves(t_lm.param_specs(_cfg(arch))))
    tol = _tol(want, f"out/part/{arch}", "grads", GRAD_TOL)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)
    assert max(np.abs(got[k]).max() for k in keys) > 0


@pytest.mark.parametrize("arch", C.PART_ARCHS)
def test_adamw_step_matches_reference_partitioned(results, arch):
    """``build_train_step(cfg, mesh)`` on the rank's share: the clipping
    norm is the whole gradient's, and every parameter leaf after the
    step within 1e-5 of the reference's update; the eval step's loss is
    the loss."""
    want, got = results
    tag = f"out/part/{arch}"
    np.testing.assert_allclose(got[f"{tag}/grad_norm"],
                               want[f"{tag}/grad_norm"],
                               **_tol(want, tag, "grad_norm"))
    keys = _keys(want, arch, "stepped/")
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    np.testing.assert_allclose(got[f"{tag}/eval_loss"], want[f"{tag}/loss"],
                               **TOL)


@pytest.mark.parametrize("arch", C.PART_ARCHS)
def test_prefill_and_decode_match_reference_partitioned(results, arch):
    """The prefill within 1e-5, and the decode steps: within 1e-5 on an
    f32 cache; on the int8 cache within two bf16 ULPs of the largest
    logit (the reference's quantized decode attends in bf16, and each
    rank's part of the row-parallel ``wo`` product rounds to bf16 before
    the sum)."""
    want, got = results
    tag = f"out/part/{arch}"
    cfg = _cfg(arch)
    for key in ["prefill_logits"] + [f"decode{i}"
                                     for i in range(C.PART_DECODE)]:
        w = want[f"{tag}/{key}"]
        tol = dict(rtol=0, atol=2 * 2.0 ** -7 * np.abs(w).max()) \
            if cfg.kv_quant and key != "prefill_logits" else \
            _tol(want, tag, key)
        np.testing.assert_allclose(got[f"{tag}/{key}"], w, err_msg=key,
                                   **tol)
    if f"{tag}/decode_slots" in got:
        # the first pattern block's K/V: the rank's slots over "model"
        # where they divide (the cache holds the VLM's patches too)
        s = C.part_seq(arch, cfg.window) + cfg.n_patches
        first = cfg.pattern[0]
        whole = (min(cfg.window, s) if first == "attn_local"
                 else s + C.PART_PAD)
        want = whole // C.TP if whole % C.TP == 0 else whole
        assert int(got[f"{tag}/decode_slots"]) == want


@pytest.mark.parametrize("arch", C.PART_ARCHS)
def test_engine_tokens_equal_reference_partitioned(results, arch):
    """``BatchedEngine(mesh=)``: its slots over "data" (each rank holds
    two of the four slots' cache), the tokens the reference's."""
    want, got = results
    tag = f"out/part/{arch}"
    for uid in range(len(C.PART_PROMPTS)):
        np.testing.assert_array_equal(got[f"{tag}/engine{uid}"],
                                      want[f"{tag}/engine{uid}"])
        assert len(got[f"{tag}/engine{uid}"]) == C.PART_NEW
    assert int(got[f"{tag}/engine_rows"]) == C.PART_SLOTS // 2


def _ref_seq_block(arch: str, n: int, d: int) -> int:
    """The positions of a (PART_B, n, d) activation laid out by ("batch",
    "seq", None) that one device of the (2, 4) mesh holds under the
    reference's ``partition_spec`` and the config's overrides."""
    jc = j_base.reduced(j_configs.ARCHS[C.PART_VARIANTS.get(
        arch, (arch,))[0]])
    mesh = type("M", (), {"shape": {"data": 2, "model": C.TP}})()
    spec = j_module.partition_spec((C.PART_B, n, d), ("batch", "seq", None),
                                   mesh, jc.sharding_overrides)
    return n // C.TP if len(spec) > 1 and spec[1] == "model" else n


@pytest.mark.parametrize("arch", C.PART_ARCHS)
def test_residual_stream_is_the_rank_block_of_the_sequence(results, arch):
    """Between the blocks each rank holds (B / 2, S / 4, D) of the
    residual stream where the reference's ``partition_spec`` cuts
    ("batch", "seq", None) under the config's overrides (Megatron
    sequence parallelism: reduced qwen2.5 and its variants, kimi-k2 and
    arctic at S = 8, internvl2's 4 patches and 8 tokens), and its rows
    whole over the sequence where it does not (smollm, gemma2,
    recurrentgemma; qwen2.5 at S = 6); the tokens come cut by their own
    length's rule."""
    _, got = results
    tag = f"out/part/{arch}"
    cfg = _cfg(arch)
    s_tok = C.part_seq(arch, cfg.window)
    s = s_tok + cfg.n_patches
    want = _ref_seq_block(arch, s, cfg.d_model)
    if arch in ("qwen2.5-32b", "kimi-k2-1t-a32b"):
        assert want == 2
    if arch in ("smollm-135m", "gemma2-2b", "recurrentgemma-9b",
                "qwen2.5-32b+seq6"):
        assert want == s
    assert got[f"{tag}/stream_shapes"].tolist() == [
        [C.PART_B // 2, want, cfg.d_model]]
    assert int(got[f"{tag}/tokens_held"]) == _ref_seq_block(arch, s_tok, 1)


def test_launchers_feed_each_rank_its_share(results):
    """``launch.train.main(mesh=)`` (reduced smollm, 3 steps of 2
    microbatches) gives the losses of the same run at world 1, and
    resumes from its checkpoint (the whole leaves, written by rank 0) to
    the same third step; ``launch.serve.main(mesh=)`` serves the tokens
    of the run at world 1."""
    _, got = results
    one = got["out/launch/train_one"]
    assert len(one) == 3
    np.testing.assert_allclose(got["out/launch/train_mesh"], one, **TOL)
    np.testing.assert_allclose(got["out/launch/train_resumed"], one[2:],
                               **TOL)
    np.testing.assert_array_equal(got["out/launch/serve_mesh"],
                                  got["out/launch/serve_one"])


def test_train_step_counts_the_rank_share_of_flops(results):
    """Reduced qwen2.5 (4 heads over 4 ranks of "model"): one rank's
    train step counts at most 1.2 x the world-1 step's FLOPs / 8."""
    _, got = results
    share = int(got["out/part/qwen2.5-32b/flops_share"])
    whole = int(got["out/part/qwen2.5-32b/flops_whole"])
    assert 0 < share <= 1.2 * whole / 8, (share, whole)


def test_recurrent_train_step_counts_the_rank_share_of_flops(results):
    """Reduced recurrentgemma (its RG-LRU cut by channel, 4 heads over 4
    ranks of "model"): one rank's train step counts at most 1.2 x the
    world-1 step's FLOPs / 8, as qwen2.5's does."""
    _, got = results
    share = int(got["out/part/recurrentgemma-9b/flops_share"])
    whole = int(got["out/part/recurrentgemma-9b/flops_whole"])
    assert 0 < share <= 1.2 * whole / 8, (share, whole)


def test_rglru_runs_on_the_rank_block_of_its_channels(results):
    """Reduced recurrentgemma (d_rnn 64 over the 4 ranks of "model"):
    the forward's scans run on the rank's rows and its 16 channels, the
    cache holds that block of each RG-LRU state (``cache_axes``: over
    ``ffn``), and a decode step gathers neither state whole: the
    all-gathers it issues (every byte ``wire_tally`` counts) are of
    other tensors."""
    _, got = results
    tag = "out/part/recurrentgemma-9b/rglru"
    cfg = _cfg("recurrentgemma-9b")
    rows, block = C.PART_B // 2, cfg.d_rnn // C.TP
    assert block == 16
    assert got[f"{tag}/scan_shapes"].tolist() == [
        [rows, C.part_seq("recurrentgemma-9b", cfg.window), block]]
    assert got[f"{tag}/state_h"].tolist() == [cfg.n_groups, rows, block]
    assert got[f"{tag}/state_conv"].tolist() == [cfg.n_groups, rows, 3,
                                                 block]
    gathered = got[f"{tag}/decode_gathered_bytes"]
    assert int(gathered.sum()) == int(got[f"{tag}/decode_gather_bytes"])
    shapes = [[d for d in row if d] for row in
              got[f"{tag}/decode_gathered_shapes"].tolist()]
    assert len(shapes) == len(gathered)
    for whole in ([rows, cfg.d_rnn], [rows, 3, cfg.d_rnn]):
        assert whole not in shapes, shapes


# ---------------------------------------------------------------------------
# In process: the layout of the batch and of the cache
# ---------------------------------------------------------------------------

def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("arch", sorted(j_configs.ARCHS))
def test_cache_axes_equal_reference(arch):
    jc, tc = j_configs.ARCHS[arch], t_configs.ARCHS[arch]
    want = jax.tree.map(tuple, j_lm.cache_axes(jc),
                        is_leaf=lambda x: isinstance(x, tuple))
    assert _as_tuples(t_lm.cache_axes(tc)) == _as_tuples(want)


class _Coords:
    """A rank's place on a mesh of ``shape`` (row-major over ``names``),
    with no process group: what ``partition_spec``, ``block`` and
    ``init_cache(mesh=)`` read."""

    def __init__(self, shape, names, rank):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))
        self.at = {}
        for name in reversed(self.axis_names):
            rank, self.at[name] = divmod(rank, self.shape[name])

    def axes(self, axes):
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def axis_size(self, axes):
        return int(np.prod([self.shape[a] for a in self.axes(axes)]))

    def axis_index(self, axes):
        i = 0
        for a in self.axes(axes):
            i = i * self.shape[a] + self.at[a]
        return i


def _ref_block(x: np.ndarray, spec, m: _Coords) -> np.ndarray:
    """The block of ``x`` a device at ``m``'s coordinates holds under the
    reference's ``PartitionSpec``."""
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        n = m.axis_size(axes)
        size = x.shape[d] // n
        idx = [slice(None)] * x.ndim
        i = m.axis_index(axes)
        idx[d] = slice(i * size, (i + 1) * size)
        x = x[tuple(idx)]
    return x


MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def _leaves_with_axes(tree, axes):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_with_axes(tree[k], axes[k])]
    return [(tree, axes)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ("qwen2.5-32b", "smollm-135m", "gemma2-2b",
                                  "kimi-k2-1t-a32b", "recurrentgemma-9b",
                                  "xlstm-350m", "internvl2-26b",
                                  "hubert-xlarge"))
def test_blocks_of_batch_and_cache_equal_reference_partition_spec(arch,
                                                                  mesh):
    """Every rank's block of a batch (``blocks_like`` of ``batch_axes``)
    and of a fresh cache (``init_cache(mesh=)``) of a reduced config
    equals the block the reference's ``partition_spec`` gives that
    device, under the config's overrides."""
    shape, names = MESHES[mesh]
    tc = t_base.reduced(t_configs.ARCHS[arch])
    jc = j_base.reduced(j_configs.ARCHS[arch])
    rules = tc.sharding_overrides
    stand_in = type("M", (), {"shape": dict(zip(names, shape))})()
    b, s = 8, 16
    kind = "train_4k"
    specs = t_lm.batch_specs(tc, kind, b, s, device="cpu")
    rs = np.random.RandomState(0)
    batch = {k: torch.from_numpy(rs.randint(0, 50, tuple(v.shape)))
             .to(v.dtype) for k, v in specs.items()}
    axes = t_lm.batch_axes(tc, kind)
    assert axes == j_lm.batch_axes(jc, kind)
    shapes_ok = None
    if not tc.encoder_only:
        whole = t_lm.init_cache(tc, b, s, device="cpu")
        # distinct values, so that a block shows where it came from
        whole = {n: {k: torch.arange(t.numel()).reshape(t.shape).to(t.dtype)
                     for k, t in e.items()} for n, e in whole.items()}
        cache_ax = t_lm.cache_axes(tc)
        shapes_ok = []
    for r in range(int(np.prod(shape))):
        m = _Coords(shape, names, r)
        got = t_module.blocks_like(batch, axes, m, rules)
        for key, x in batch.items():
            spec = j_module.partition_spec(tuple(x.shape), axes[key],
                                           stand_in, jc.sharding_overrides)
            np.testing.assert_array_equal(
                got[key].numpy(), _ref_block(x.numpy(), spec, m), err_msg=key)
        if shapes_ok is None:
            continue
        mine = t_lm.init_cache(tc, b, s, device="cpu", mesh=m)
        cut = t_module.blocks_like(whole, cache_ax, m, rules)
        for (t, ax), (c, _), (w, _) in zip(
                _leaves_with_axes(mine, cache_ax),
                _leaves_with_axes(cut, cache_ax),
                _leaves_with_axes(whole, cache_ax)):
            spec = j_module.partition_spec(tuple(w.shape), ax, stand_in,
                                           jc.sharding_overrides)
            np.testing.assert_array_equal(c.numpy(),
                                          _ref_block(w.numpy(), spec, m))
            assert t.shape == c.shape and t.is_contiguous()
            shapes_ok.append(any(p is not None for p in spec))
    if shapes_ok is not None:
        assert any(shapes_ok)     # some cache leaf is cut on this mesh


@pytest.mark.parametrize("batch,want", [(8, ("data",)), (3, ()),
                                        (None, ("data",))])
def test_plan_splits_the_rows_where_the_batch_divides(batch, want):
    m = _Coords((2, 4), ("data", "model"), 5)
    plan = t_module.plan(m, batch=batch, cache_len=16)
    assert plan.dp == want and plan.tp == "model" and plan.tp_size == 4
    assert plan.tp_index == 1 and plan.cache_len == 16
    assert t_module.plan(plan) is plan
    assert t_module.plan(None) is None
    one = _Coords((1, 1), ("data", "model"), 0)
    assert t_module.plan(one).tp is None
