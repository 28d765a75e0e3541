"""The port's multi-rank LM path against the JAX package's mesh.

The reference side runs in one subprocess on 8 simulated host devices,
a (2, 4) ("data", "model") mesh (``tests/_dist_reference_jax.py``, set up
as ``tests/test_dist.py`` does); the port's in one subprocess that
spawns 8 gloo ranks on a TCP store at a free port, one thread each
(``tests/_dist_ranks_torch.py``), on the operands the reference side
drew from ``numpy.random.RandomState`` (the LMs' parameters from its
``materialize``).  A mesh path is a different function from ``moe_ref``
wherever capacity drops an assignment (the per-shard token order decides
which), so the port's mesh paths are held to JAX's on the same mesh:

* every expert-parallel path's output within rtol / atol 1e-5 in f32 at
  capacity factors 8.0 and 1.25, its ``aux`` within 1e-6 of the same
  path's, the winners and the kept assignments of every rank exactly
  equal, and every rank holding the same full output;
* ``jax.grad`` of ``sum(y**2) + 0.01 * aux`` through ``moe_2d`` and
  ``moe_a2a`` within 1e-4;
* every path on MoE parameters held as a rank's blocks (``specs=``)
  equal to JAX's on the same case, with the experts cut over the ranks;
* reduced kimi-k2 and arctic (``moe_2d`` / ``moe_dense_ep_2d``) on each
  rank's blocks of the parameters: ``forward``'s logits and aux,
  ``loss_fn`` and every gradient leaf (gathered whole), a prefill and
  three decode steps, and ``forward`` on parameters saved from a (1, 8)
  layout and restored on the (2, 4) mesh.

In process, without ranks: ``partition_spec`` equal to the reference's
for every leaf of every registry config under its overrides on three
mesh shapes, the blocks of a layout tiling the full tensor, and a
checkpoint saved from a (1, 4) layout restoring on (2, 2).
"""

import os
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import lm as j_lm
from repro.nn import module as j_module
from repro_torch import configs as t_configs
from repro_torch.configs import base as t_base
from repro_torch.models import lm as t_lm
from repro_torch.nn import module as t_module
from repro_torch.train import checkpoint as t_ckpt

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _dist_cases as C  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
ROUTED = [c for c in C.CASES if c[1] in ("a2a", "2d")
          and "wire_dtype" not in c[4]]


def _run(args, timeout):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, *map(str, args)], env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-4000:]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    ref, port = d / "ref.npz", d / "port.npz"
    _run([ROOT / "tests" / "_dist_reference_jax.py", ref], timeout=300)
    _run([ROOT / "tests" / "_dist_ranks_torch.py", "moe", ref, port],
         timeout=300)
    with np.load(ref) as r, np.load(port) as t:
        yield dict(r), dict(t)


@pytest.mark.parametrize("case", [c[0] for c in C.CASES])
def test_ep_path_matches_jax_mesh(results, case):
    want, got = results
    np.testing.assert_allclose(got[f"out/{case}/y"], want[f"out/{case}/y"],
                               **TOL)
    assert abs(float(got[f"out/{case}/aux"])
               - float(want[f"out/{case}/aux"])) <= 1e-6
    assert float(got[f"rank_spread/out/{case}/y"]) == 0.0


@pytest.mark.parametrize("case", [c[0] for c in ROUTED])
def test_routing_and_kept_assignments_equal(results, case):
    want, got = results
    np.testing.assert_array_equal(got[f"out/{case}/idx"],
                                  want[f"out/{case}/idx"])
    np.testing.assert_array_equal(got[f"out/{case}/kept"],
                                  want[f"out/{case}/kept"])
    dropped = got[f"out/{case}/dropped"]
    np.testing.assert_array_equal(
        dropped, (~want[f"out/{case}/kept"]).reshape(8, -1).sum(-1))
    if case.endswith("cf8"):
        assert dropped.sum() == 0
    else:
        assert dropped.sum() > 0      # 1.25 drops: the order matters


@pytest.mark.parametrize("case", ["a2a_cf8", "2d_cf8", "dense_ep",
                                  "dense_ep_2d"])
def test_no_drop_paths_equal_moe_ref(results, case):
    want, got = results
    np.testing.assert_allclose(got[f"out/{case}/y"], want["out/ref/y"],
                               **TOL)


def test_int8_wire_quantises_the_dispatch(results):
    want, got = results
    y8, y = got["out/2d_int8_cf8/y"], got["out/2d_cf8/y"]
    err = np.abs(y8 - y).max()
    assert 0.0 < err < 0.05 * np.abs(y).max(), err


@pytest.mark.parametrize("path", ["2d", "a2a"])
def test_ep_gradients_match_jax_grad(results, path):
    want, got = results
    keys = [k for k in want if k.startswith(f"out/grad_{path}/")]
    assert len(keys) == 5
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)
        assert np.abs(got[k]).max() > 0, k


@pytest.mark.parametrize("kind", sorted(C.HELD))
def test_ep_path_on_held_blocks_matches_jax_mesh(results, kind):
    """The path on its rank's blocks of the MoE parameters (the experts
    cut over the ranks, no rank holding all of them) gives JAX's output,
    aux and, through ``moe_2d`` and ``moe_a2a``, gradients."""
    want, got = results
    case, _ = C.HELD[kind]
    np.testing.assert_allclose(got[f"out/held_{kind}/y"],
                               want[f"out/{case}/y"], **TOL)
    assert abs(float(got[f"out/held_{kind}/aux"])
               - float(want[f"out/{case}/aux"])) <= 1e-6
    assert float(got[f"rank_spread/out/held_{kind}/y"]) == 0.0
    assert int(got[f"out/held_{kind}/experts"]) < C.E
    if kind in ("2d", "a2a"):
        keys = [k for k in want if k.startswith(f"out/grad_{kind}/")]
        for k in keys:
            np.testing.assert_allclose(
                got[k.replace("out/grad_", "out/held_grad_")], want[k],
                err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("arch", C.LM_ARCHS)
def test_lm_forward_matches_jax_mesh(results, arch):
    want, got = results
    for key in ("logits", "aux"):
        np.testing.assert_allclose(got[f"out/{arch}/{key}"],
                                   want[f"out/{arch}/{key}"], **TOL)
    assert float(got[f"rank_spread/out/{arch}/logits"]) == 0.0


@pytest.mark.parametrize("arch", C.LM_ARCHS)
def test_lm_loss_and_gradients_match_jax_mesh(results, arch):
    want, got = results
    for key in ("loss", "ce"):
        np.testing.assert_allclose(got[f"out/{arch}/{key}"],
                                   want[f"out/{arch}/{key}"], **TOL)
    keys = [k for k in want if k.startswith(f"out/{arch}/grads/")]
    assert any("/moe/w_in" in k for k in keys)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("arch", C.LM_ARCHS)
def test_lm_prefill_and_decode_match_jax_mesh(results, arch):
    want, got = results
    for key in ["prefill_logits"] + [f"decode{i}"
                                     for i in range(C.LM_DECODE)]:
        np.testing.assert_allclose(got[f"out/{arch}/{key}"],
                                   want[f"out/{arch}/{key}"], err_msg=key,
                                   **TOL)


@pytest.mark.parametrize("arch", C.LM_ARCHS)
def test_lm_engine_eval_and_train_steps_through_the_mesh(results, arch):
    """``BatchedEngine(mesh=)`` (two slots, two prompts) generates JAX's
    tokens; ``build_eval_step(cfg, mesh)`` gives JAX's ``loss_fn`` loss;
    ``build_train_step(cfg, mesh)`` is AdamW on the mesh's gradients,
    the same parameters on every rank."""
    want, got = results
    for uid in range(len(C.ENGINE_PROMPTS)):
        np.testing.assert_array_equal(got[f"out/{arch}/engine{uid}"],
                                      want[f"out/{arch}/engine{uid}"])
        assert len(got[f"out/{arch}/engine{uid}"]) == C.ENGINE_NEW
    np.testing.assert_allclose(got[f"out/{arch}/eval_loss"],
                               want[f"out/{arch}/loss"], **TOL)
    assert float(got[f"out/{arch}/train_step_err"]) == 0.0
    assert float(got[f"rank_spread/out/{arch}/train_step_params"]) == 0.0
    # the clipping norm is the whole gradient's, from the blocks
    np.testing.assert_allclose(got[f"out/{arch}/block_norm"],
                               got[f"out/{arch}/whole_norm"], rtol=1e-6)


@pytest.mark.parametrize("arch", C.LM_ARCHS)
def test_lm_on_blocks_restored_from_another_layout(results, arch):
    """Each rank holds a part of the experts; parameters saved from a
    (1, 8) layout's blocks restore on the (2, 4) mesh as the blocks
    ``local_params`` cuts, and ``forward`` on them gives JAX's logits."""
    want, got = results
    assert int(got[f"out/{arch}/experts_held"]) < t_base.reduced(
        t_configs.ARCHS[arch]).n_experts
    assert bool(got[f"out/{arch}/restored_blocks_equal"])
    np.testing.assert_allclose(got[f"out/{arch}/restored_logits"],
                               want[f"out/{arch}/logits"], **TOL)
    assert float(got[f"rank_spread/out/{arch}/restored_logits"]) == 0.0


def test_host_and_production_meshes(results):
    _, got = results
    assert got["out/host_mesh"].tolist() == [1, 8]
    assert bool(got["out/production_refused"])


def test_mesh_coordinates_and_axis_index(results):
    """On a (2, 2, 2) ("pod", "data", "model") mesh of the 8 ranks: the
    coordinates row-major, ``rank_of`` their inverse, the joint index
    over ("pod", "data") the first axis major; an axis out of the mesh's
    order and a missing axis raise."""
    _, got = results
    ranks = got["out/coords/rank"]
    assert ranks.tolist() == list(range(8))
    coords = got["out/coords/coords"]
    assert coords.tolist() == [[r // 4, r // 2 % 2, r % 2] for r in ranks]
    assert got["out/coords/rank_of"].tolist() == ranks.tolist()
    assert got["out/coords/pod_data"].tolist() == [
        c[0] * 2 + c[1] for c in coords.tolist()]
    assert got["out/coords/model"].tolist() == [r % 2 for r in ranks]
    assert got["out/coords/errors"].all()


def test_shard_unshard_round_trip_is_unscaled(results):
    """x -> shard -> unshard is x on every rank, and the gradient of
    sum(y * w) is w (not 8 w, the trap of a reduce-scatter at the output
    edge), for row, column, joint and replicated layouts."""
    _, got = results
    x0 = np.arange(64, dtype=np.float32).reshape(8, 8)
    w = torch.linspace(-1.0, 1.0, 64).reshape(8, 8).numpy()
    blocks = {"data_rows": (4, 8), "model_cols": (8, 2), "both": (4, 2),
              "joint_rows": (1, 8), "replicated": (8, 8)}
    for name, shape in blocks.items():
        np.testing.assert_array_equal(got[f"out/roundtrip/{name}/y"], x0)
        np.testing.assert_allclose(got[f"out/roundtrip/{name}/grad"], w,
                                   rtol=1e-6, atol=1e-7, err_msg=name)
        assert tuple(got[f"out/roundtrip/{name}/block"]) == shape


# ---------------------------------------------------------------------------
# In process: the layout rules, blocks and the elastic restore
# ---------------------------------------------------------------------------

MESH_SHAPES = {"2x4": {"data": 2, "model": 4},
               "2x2x4": {"pod": 2, "data": 2, "model": 4},
               "16x16": {"data": 16, "model": 16}}


@pytest.mark.parametrize("mesh", sorted(MESH_SHAPES))
@pytest.mark.parametrize("arch", sorted(j_configs.ARCHS))
def test_partition_spec_equals_reference(arch, mesh):
    """Every leaf of the full-size config's ``param_specs`` under its
    ``sharding_overrides``: the reference reads only ``mesh.shape``."""
    stand_in = types.SimpleNamespace(shape=MESH_SHAPES[mesh])
    jc, tc = j_configs.ARCHS[arch], t_configs.ARCHS[arch]
    js = jax.tree.leaves(j_lm.param_specs(jc), is_leaf=j_module.is_spec)
    ts = t_module.leaves(t_lm.param_specs(tc))
    assert len(js) == len(ts)
    for j, t in zip(js, ts):
        assert (j.shape, j.axes) == (t.shape, t.axes)
        want = j_module.partition_spec(j.shape, j.axes, stand_in,
                                       jc.sharding_overrides)
        got = t_module.partition_spec(t.shape, t.axes, stand_in,
                                      tc.sharding_overrides)
        assert got == tuple(want), (arch, t.shape, t.axes, got, want)
    shard_tree = t_module.shardings(t_lm.param_specs(tc), stand_in,
                                    tc.sharding_overrides)
    assert [s.spec for s in t_module.leaves(shard_tree)] == [
        t_module.partition_spec(t.shape, t.axes, stand_in,
                                tc.sharding_overrides) for t in ts]


def test_partition_spec_fallback_and_no_reuse():
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 4})
    # 6 does not divide over model's 4: dropped, never an error
    assert t_module.partition_spec((6, 8), ("vocab", "ffn"), mesh) == (
        None, "model")
    # vocab took "model": ffn may not take it again
    assert t_module.partition_spec((8, 8), ("vocab", "ffn"), mesh) == (
        "model",)
    # "pod" is not in the mesh; batch keeps "data"
    assert t_module.partition_spec((4, 3), ("batch", None), mesh) == (
        "data",)
    assert t_module.partition_spec((8,), ("batch",), mesh,
                                   {"batch": ("data", "model")}) == (
        ("data", "model"),)
    # 4 takes "data" (2) but not also "model" (2 x 4 = 8)
    assert t_module.partition_spec((4,), ("batch",), mesh,
                                   {"batch": ("data", "model")}) == (
        "data",)


def _assemble(blocks, spec, meshes, shape):
    """The full tensor from every rank's block, each element placed
    through the block of an index tensor; every element exactly once."""
    idx = torch.arange(int(np.prod(shape))).reshape(shape)
    out = torch.zeros(int(np.prod(shape)), dtype=blocks[0].dtype)
    seen = torch.zeros(int(np.prod(shape)), dtype=torch.int64)
    for b, m in zip(blocks, meshes):
        where = t_module.block(idx, spec, m).reshape(-1)
        out[where] = b.reshape(-1)
        seen[where] += 1
    return out.reshape(shape), seen


class _Coords:
    """A rank's place on a mesh of ``shape`` (row-major over ``names``),
    with no process group: what ``partition_spec`` and ``block`` read."""

    def __init__(self, shape, names, rank):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))
        self._at = {}
        for name in reversed(self.axis_names):
            rank, self._at[name] = divmod(rank, self.shape[name])

    def axis_size(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.prod([self.shape[a] for a in axes]))

    def axis_index(self, axes):
        i = 0
        for a in ((axes,) if isinstance(axes, str) else tuple(axes)):
            i = i * self.shape[a] + self._at[a]
        return i


def _meshes(shape, names):
    return [_Coords(shape, names, r) for r in range(int(np.prod(shape)))]


@pytest.mark.parametrize("spec", [("data",), (None, "model"),
                                  ("data", "model"), (("data", "model"),),
                                  ()])
def test_blocks_tile_the_full_tensor(spec):
    full = torch.randn(8, 12, generator=torch.Generator().manual_seed(0))
    meshes = _meshes((2, 4), ("data", "model"))
    blocks = [t_module.block(full, spec, m) for m in meshes]
    got, seen = _assemble(blocks, spec, meshes, full.shape)
    torch.testing.assert_close(got, full, rtol=0, atol=0)
    n_named = int(np.prod([2 if a == "data" else 4 for part in spec
                           if part is not None
                           for a in ((part,) if isinstance(part, str)
                                     else part)]))
    assert (seen == 8 // n_named).all()


def test_relayout_uses_a_block_held_in_the_wanted_layout():
    """A block already in the path's layout is used as held, whatever
    trailing ``None``s either spec carries: no gather, no copy (here no
    rank holds the same block, so nothing is summed either)."""
    m = _Coords((2, 4), ("data", "model"), 5)
    x = torch.zeros(4, 2, 3)
    for have, want in ((("data", None, "model"), ("data", None, "model")),
                       (("data", "model"), ("data", "model", None)),
                       ((("data", "model"),), (("data", "model"), None))):
        assert t_module.relayout(x, have, want, m) is x, (have, want)


def test_checkpoint_saved_on_one_mesh_restores_on_another(tmp_path):
    """Reduced kimi-k2's parameters laid out on a (1, 4) mesh, gathered
    and saved, restore on a (2, 2) mesh: every rank's blocks assemble to
    the saved full leaves, bit for bit."""
    cfg = t_base.reduced(t_configs.ARCHS["kimi-k2-1t-a32b"])
    specs = t_lm.param_specs(cfg)
    full = t_module.materialize(specs, torch.Generator().manual_seed(0),
                                device="cpu")
    rules = cfg.sharding_overrides
    src = _meshes((1, 4), ("data", "model"))
    local = [t_module.local_params(full, specs, m, rules) for m in src]
    shard_src = t_module.shardings(specs, src[0], rules)
    saved = t_module.unflatten(full, [
        _assemble([t_module.leaves(lp)[i] for lp in local],
                  t_module.leaves(shard_src)[i].spec, src,
                  leaf.shape)[0]
        for i, leaf in enumerate(t_module.leaves(full))])
    t_ckpt.save(str(tmp_path), 3, {"params": saved})
    dst = _meshes((2, 2), ("data", "model"))
    restored = []
    for m in dst:
        sh = t_module.shardings(specs, m, rules)
        out, meta = t_ckpt.restore(str(tmp_path), 3, {"params": full},
                                   shardings={"params": sh})
        assert meta["step"] == 3
        restored.append(out["params"])
    specs_dst = [s.spec for s in t_module.leaves(
        t_module.shardings(specs, dst[0], rules))]
    assert any(s for s in specs_dst)     # some leaf is cut on (2, 2)
    for i, leaf in enumerate(t_module.leaves(full)):
        got, seen = _assemble([t_module.leaves(r)[i] for r in restored],
                              specs_dst[i], dst, leaf.shape)
        torch.testing.assert_close(got, leaf, rtol=0, atol=0)
        assert (seen > 0).all()
    latest = t_ckpt.restore_latest(str(tmp_path), {"params": full},
                                   shardings={"params": t_module.shardings(
                                       specs, dst[3], rules)})
    for a, b in zip(t_module.leaves(latest[0]["params"]),
                    t_module.leaves(restored[3])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_new_modules_import_no_jax_or_repro():
    pattern = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro)\b",
                         re.MULTILINE)
    src = ROOT / "src" / "repro_torch"
    for rel in ("launch/mesh.py", "dist/__init__.py", "dist/collectives.py",
                "dist/pipeline.py", "nn/module.py", "nn/moe.py",
                "models/lm.py", "train/train_loop.py",
                "train/checkpoint.py", "serve/engine.py"):
        hits = pattern.findall((src / rel).read_text())
        assert not hits, f"{rel} imports {hits}"
    ranks = (ROOT / "tests" / "_dist_ranks_torch.py").read_text()
    assert not pattern.findall(ranks)
