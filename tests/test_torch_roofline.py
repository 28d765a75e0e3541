"""The roofline model, the perf ladders and the wire tally of the port
against the JAX package on the CPU.

* ``roofline.flops_model.analyze`` equals the reference's, field by
  field and exactly, with the reference module's ``PEAK_FLOPS``,
  ``HBM_BW`` and ``ICI_BW`` set to the port's H100 constants: every
  runnable cell on both meshes at ``n_micro`` 1 and 8 and both widths of
  gradients and moments, every ladder variant, and an explicit
  ``remat_factor``; and the reference's ``TestFlopsModel`` on the port.
* ``launch.hillclimb``: ``_analyze`` of every ladder entry and
  ``run_cell(cell, compile_variants=False)`` give the reference's
  entries and verdicts (its ``run_cell`` imports ``repro.launch.dryrun``,
  which cannot be imported, so a stand-in module takes its place), under
  the H100 constants and under the reference's own.
* ``dist.collectives.wire_tally`` by hand on a fake 4-rank world, and
  ``roofline.analysis.collective_bytes`` / ``from_counts`` on it.
* The model against counted FLOPs (the reference's
  ``TestRooflineModelValidation``): within 0.65-1.5.
"""

import dataclasses
import os
import sys
import types

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as j_configs
from repro.roofline import analysis as j_analysis
from repro.roofline import flops_model as j_fm
from repro_torch import configs as t_configs
from repro_torch.dist import collectives
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm
from repro_torch.nn import module
from repro_torch.roofline import analysis, flops_model

torch.set_num_threads(1)

H100 = {"PEAK_FLOPS": 989e12, "HBM_BW": 3.35e12, "ICI_BW": 450e9}
TPU = {"PEAK_FLOPS": 197e12, "HBM_BW": 819e9, "ICI_BW": 50e9}
CELLS = j_configs.cells()
VARIANTS = [(cell, name, overrides)
            for cell, (_, _, ladder) in hillclimb.LADDERS.items()
            for name, _, overrides in ladder]


@pytest.fixture
def ref_h100(monkeypatch):
    """The reference's model under the port's constants."""
    for k, v in H100.items():
        monkeypatch.setattr(j_fm, k, v)


@pytest.fixture
def j_hill(monkeypatch, tmp_path):
    """The reference's ``launch.hillclimb``, its results under
    ``tmp_path``, with a stand-in for ``repro.launch.dryrun`` (which
    imports ``repro.dist.sharding``, a module the JAX package lacks).
    Importing it sets ``XLA_FLAGS`` to 512 host devices where unset; the
    variable is put back at once, before JAX reads it."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import hillclimb as j
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    monkeypatch.setitem(sys.modules, "repro.launch.dryrun",
                        types.ModuleType("repro.launch.dryrun"))
    monkeypatch.setattr(j, "OUT_DIR", str(tmp_path / "ref"))
    monkeypatch.setattr(hillclimb, "OUT_DIR", str(tmp_path / "port"))
    return j


def _both(arch, overrides=None):
    jc, tc = j_configs.get_config(arch), t_configs.get_config(arch)
    if overrides:
        jc = dataclasses.replace(jc, **overrides)
        tc = dataclasses.replace(tc, **overrides)
    return jc, tc


def test_model_counts_the_same_parameters():
    for arch in t_configs.ARCHS:
        jc, tc = _both(arch)
        assert tc.param_count() == jc.param_count(), arch
        assert tc.active_param_count() == jc.active_param_count(), arch
    assert len(CELLS) == 31


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analyze_equals_reference_on_every_cell(ref_h100, arch, shape):
    jc, tc = _both(arch)
    for multi in (False, True):
        for n_micro in (1, 8):
            for gb, mb in ((4, 4), (2, 2), (4, 2)):
                kw = dict(n_micro=n_micro, grad_bytes=gb, moment_bytes=mb)
                want = j_fm.analyze(jc, shape, j_fm.mesh_for(multi), **kw)
                got = flops_model.analyze(tc, shape,
                                          flops_model.mesh_for(multi), **kw)
                assert got == want, (arch, shape, multi, kw)


@pytest.mark.parametrize("cell,name,overrides", VARIANTS,
                         ids=[f"{c}-{n}" for c, n, _ in VARIANTS])
def test_analyze_equals_reference_on_every_ladder_variant(ref_h100, cell,
                                                           name, overrides):
    arch, shape, _ = hillclimb.LADDERS[cell]
    overrides = dict(overrides)
    n_micro = overrides.pop("_n_micro", 8)
    jc, tc = _both(arch, overrides)
    for multi in (False, True):
        want = j_fm.analyze(jc, shape, j_fm.mesh_for(multi), n_micro=n_micro)
        got = flops_model.analyze(tc, shape, flops_model.mesh_for(multi),
                                  n_micro=n_micro)
        assert got == want


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "nemotron-4-340b",
                                  "gemma2-2b"])
def test_analyze_equals_reference_with_explicit_remat_factor(ref_h100, arch):
    jc, tc = _both(arch)
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        for rf in (3.0, 3.5, 4.0):
            want = j_fm.analyze(jc, shape, j_fm.MeshShape(), n_micro=4,
                                remat_factor=rf)
            got = flops_model.analyze(tc, shape, flops_model.MeshShape(),
                                      n_micro=4, remat_factor=rf)
            assert got == want


def test_fwd_flops_per_token_equals_reference():
    for arch in t_configs.ARCHS:
        jc, tc = _both(arch)
        for kind, s in (("train", 4096), ("prefill", 32768),
                        ("decode", 32768)):
            for head in (False, True):
                assert flops_model.fwd_flops_per_token(tc, kind, s, head) \
                    == j_fm.fwd_flops_per_token(jc, kind, s, head)


def test_mesh_shape_and_constants():
    assert flops_model.mesh_for(False) == flops_model.MeshShape(1, 16, 16)
    assert flops_model.mesh_for(True).n_dev == 512
    assert flops_model.mesh_for(True).dp == 32
    assert (flops_model.PEAK_FLOPS, flops_model.HBM_BW,
            flops_model.ICI_BW) == (989e12, 3.35e12, 450e9)
    assert lm.SHAPES == {"train_4k": dict(kind="train", seq=4096, batch=256),
                         "prefill_32k": dict(kind="prefill", seq=32768,
                                             batch=32),
                         "decode_32k": dict(kind="decode", seq=32768,
                                            batch=128),
                         "long_500k": dict(kind="decode", seq=524288,
                                           batch=1)}


# --- the reference's TestFlopsModel on the port -----------------------------

@pytest.mark.parametrize("multi", [False, True])
def test_all_cells_finite_and_positive(multi):
    for arch, shape in t_configs.cells():
        cfg = t_configs.get_config(arch)
        r = flops_model.analyze(cfg, shape, flops_model.mesh_for(multi),
                                n_micro=8 if shape == "train_4k" else 1)
        for k in ("compute_s", "memory_s", "collective_s"):
            assert r[k] >= 0.0, (arch, shape, k)
        assert r["bound_s"] > 0
        assert 0 <= r["roofline_frac"] <= 1.2, (arch, shape, r)


def test_multi_pod_scales_compute_down():
    cfg = t_configs.get_config("qwen2.5-32b")
    s1 = flops_model.analyze(cfg, "train_4k", flops_model.mesh_for(False),
                             n_micro=8)
    s2 = flops_model.analyze(cfg, "train_4k", flops_model.mesh_for(True),
                             n_micro=8)
    assert s2["compute_s"] == pytest.approx(s1["compute_s"] / 2, rel=0.01)


def test_kv_quant_reduces_decode_memory():
    cfg = t_configs.get_config("qwen2.5-32b")
    mesh = flops_model.mesh_for(False)
    base = flops_model.analyze(cfg, "decode_32k", mesh)
    q8 = flops_model.analyze(dataclasses.replace(cfg, kv_quant="int8"),
                             "decode_32k", mesh)
    q4 = flops_model.analyze(dataclasses.replace(cfg, kv_quant="int4"),
                             "decode_32k", mesh)
    assert q8["memory_s"] < base["memory_s"] * 0.65
    assert q4["memory_s"] < q8["memory_s"]


def test_useful_flops_below_impl():
    cfg = t_configs.get_config("nemotron-4-340b")
    r = flops_model.analyze(cfg, "train_4k", flops_model.mesh_for(False),
                            n_micro=8)
    assert r["useful_flops_per_device"] <= r["flops_per_device"]
    assert r["model_flops_per_device"] <= r["flops_per_device"]


# --- the ladders -------------------------------------------------------------

@pytest.mark.parametrize("cell,name,overrides", VARIANTS,
                         ids=[f"{c}-{n}" for c, n, _ in VARIANTS])
def test_analyze_of_every_ladder_entry_equals_reference(ref_h100, j_hill,
                                                         cell, name,
                                                         overrides):
    arch, shape, _ = hillclimb.LADDERS[cell]
    overrides = dict(overrides)
    n_micro = overrides.pop("_n_micro", 8)
    jc, tc = _both(arch, overrides)
    assert hillclimb._analyze(tc, shape, n_micro=n_micro) == \
        j_hill._analyze(jc, shape, n_micro=n_micro)


def _strip(entries):
    return [{k: v for k, v in e.items() if k != "hypothesis"}
            for e in entries]


def test_ladders_are_the_reference_ladders(j_hill):
    assert set(hillclimb.LADDERS) == set(j_hill.LADDERS)
    for cell, (arch, shape, ladder) in hillclimb.LADDERS.items():
        j_arch, j_shape, j_ladder = j_hill.LADDERS[cell]
        assert (arch, shape) == (j_arch, j_shape)
        assert [(n, o) for n, _, o in ladder] == \
            [(n, o) for n, _, o in j_ladder]
        for _, hypothesis, _ in ladder:
            # no figure worked out for the TPU: seconds or megabytes
            assert "MB" not in hypothesis and "s wire" not in hypothesis


@pytest.mark.parametrize("constants", ["h100", "tpu"])
@pytest.mark.parametrize("cell", sorted(hillclimb.LADDERS))
def test_run_cell_equals_reference(j_hill, monkeypatch, cell, constants):
    table = H100 if constants == "h100" else TPU
    for k, v in table.items():
        monkeypatch.setattr(j_fm, k, v)
        monkeypatch.setattr(flops_model, k, v)
    want = j_hill.run_cell(cell, compile_variants=False)
    got = hillclimb.run_cell(cell, compile_variants=False)
    assert _strip(got) == _strip(want)
    assert os.path.exists(os.path.join(hillclimb.OUT_DIR, f"{cell}.json"))


# the accepted entries under the H100 constants (model output, 256
# devices): (name, bound s a step, roofline fraction)
H100_ACCEPTED = {"kimi": ("dots_remat", 1.049, 0.863),
                 "nemotron": ("dots_remat", 8.862, 0.956),
                 "qwen": ("kv_int4", 0.001, 0.036)}


@pytest.mark.parametrize("cell", sorted(H100_ACCEPTED))
def test_run_cell_verdicts_under_h100_constants(tmp_path, monkeypatch,
                                                cell):
    monkeypatch.setattr(hillclimb, "OUT_DIR", str(tmp_path))
    res = hillclimb.run_cell(cell, compile_variants=False)
    accepted = [e for e in res if e.get("accepted_final")]
    assert len(accepted) == 1
    name, bound, frac = H100_ACCEPTED[cell]
    a = accepted[0]["analytical"]
    assert accepted[0]["name"] == name
    assert round(a["bound_s"], 3) == bound
    assert round(a["roofline_frac"], 3) == frac
    if cell == "kimi":
        # the dominant term turns from collective to compute
        by = {e["name"]: e for e in res}
        assert by["cap_1.0"]["analytical"]["dominant"] == "collective"
        assert by["attn_only_remat"]["analytical"]["dominant"] == "compute"
        assert by["attn_only_remat"]["verdict"] == "confirmed"


def test_hillclimb_main_writes_every_cell(tmp_path, monkeypatch):
    monkeypatch.setattr(hillclimb, "OUT_DIR", str(tmp_path))
    hillclimb.main(["--no-compile"])
    assert sorted(os.listdir(tmp_path)) == ["kimi.json", "nemotron.json",
                                            "qwen.json"]


# --- the wire tally -----------------------------------------------------------

def test_collective_bytes_keys_equal_reference_plus_broadcast():
    want = j_analysis.collective_bytes("")
    with collectives.wire_tally() as tally:
        pass
    got = analysis.collective_bytes(tally)
    assert set(got) == set(want) | {"broadcast_bytes", "broadcast_count"}
    assert all(v == 0 for v in got.values())
    for k, f in j_analysis._WIRE_FACTOR.items():
        assert analysis._WIRE_FACTOR[k] == f
    assert analysis._WIRE_FACTOR["broadcast"] == 1.0


def test_wire_tally_by_hand_on_a_fake_world():
    """Each kind's bytes are its result's: all-reduce the input's size
    (x2 on the wire), all-gather the gathered size, reduce-scatter the
    scattered size, all-to-all the input's size, broadcast the value's;
    backward transposes count as they run; nothing is counted with the
    tally closed."""
    with dryrun.fake_world(4):
        mesh = Mesh((2, 2), ("data", "model"))
        x = torch.empty(4, 8, device="meta", requires_grad=True)  # 128 B
        collectives.psum(x.detach(), mesh, "model")                # outside
        assert collectives._tally is None
        with collectives.wire_tally() as tally:
            collectives.psum(x.detach(), mesh, "model")            # 128
            collectives.all_gather(x.detach(), mesh, "data", 0)    # 256
            collectives.psum_scatter(x.detach(), mesh, "model", 0)  # 64
            collectives.all_to_all(x.detach(), mesh, "model", 0, 1)  # 128
            collectives.replicate(x.detach(), mesh, "model")       # 128
            y = collectives.all_gather(x, mesh, ("data", "model"), 1)
            y.sum().backward()                 # gather 512, scatter 128
            q = torch.empty(4, 8, dtype=torch.int8, device="meta")
            collectives.all_to_all(q, mesh, "data", 0, 1)          # 32
        assert collectives._tally is None
    assert tally.bytes == {"all-reduce": 128, "all-gather": 256 + 512,
                           "reduce-scatter": 64 + 128, "all-to-all": 128 + 32,
                           "collective-permute": 0, "broadcast": 128}
    assert tally.count == {"all-reduce": 1, "all-gather": 2,
                           "reduce-scatter": 2, "all-to-all": 2,
                           "collective-permute": 0, "broadcast": 1}
    got = analysis.collective_bytes(tally)
    assert got["all-reduce_bytes"] == 256.0
    assert got["total_wire_bytes"] == 256 + 768 + 192 + 160 + 128
    roof = analysis.from_counts(1e12, 2e9, tally, 5e11)
    assert roof.wire_bytes_per_device == got["total_wire_bytes"]
    assert roof.compute_s == 1e12 / 989e12
    assert roof.as_dict()["useful_flops_frac"] == 0.5


# --- the model against counted FLOPs -------------------------------------------

def test_flops_model_matches_counted_flops():
    """The reference's ``TestRooflineModelValidation`` on the port: one
    layer, d_model 128, vocab 512, remat off, f32, b=4, s=256: the
    counted FLOPs of ``loss_fn``'s value and gradients within 0.65-1.5 of
    the model's forward units x 3."""
    base = t_configs.ARCHS["smollm-135m"]
    cfg = dataclasses.replace(
        t_configs.reduced(base, n_layers=1, d_model=128, vocab=512),
        remat=False, dtype="float32")
    params = module.materialize(lm.param_specs(cfg),
                                torch.Generator().manual_seed(0),
                                device="cpu")
    b, s = 4, 256
    rng = np.random.RandomState(1)
    batch = {"tokens": torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                    (b, s)))}
    live = module.tree_map(lambda t: t.requires_grad_(), params)
    with FlopCounterMode(display=False) as fc:
        loss, _ = lm.loss_fn(live, batch, cfg)
        torch.autograd.grad(loss, module.leaves(live), allow_unused=True)
    counted = fc.get_total_flops()
    fwd_i, _ = flops_model.fwd_flops_per_token(cfg, "train", s,
                                               with_full_head=True)
    ratio = fwd_i * b * s * 3.0 / counted
    assert 0.65 < ratio < 1.5, (counted, ratio)


# --- the report --------------------------------------------------------------

def _cell(arch, shape, mesh):
    return {"arch": arch, "shape": shape, "mesh": mesh,
            "n_micro": 8 if shape == "train_4k" else 1,
            "grad_dtype": "bfloat16", "moment_dtype": "bfloat16",
            "bytes_per_device": 70 * 2 ** 30, "flops": 3e15,
            "collectives_counted": {"total_wire_bytes": 1e10}}


def test_roofline_report_rows_equal_reference(ref_h100, tmp_path):
    from benchmarks import roofline_report as j_report
    from experiments_torch import roofline_report, make_experiments
    dry = tmp_path / "dry"
    dry.mkdir()
    cells = [_cell("kimi-k2-1t-a32b", "train_4k", "16x16"),
             _cell("qwen2.5-32b", "decode_32k", "2x16x16")]
    for i, c in enumerate(cells):
        (dry / f"{i}.json").write_text(__import__("json").dumps(c))
    rows = [roofline_report.row(c) for c in roofline_report.load_cells(
        str(dry))]
    for got, c in zip(rows, cells):
        want = j_report.row(c)
        for k in ("compute_s", "memory_s", "collective_s", "dominant",
                  "model_over_impl_flops", "roofline_frac",
                  "mem_gib_per_dev"):
            assert got[k] == want[k], k
        assert got["fits_h100_80g"] and "fits_v5e_16g" not in got
    rep = roofline_report.run(str(dry))
    assert rep["n_cells_counted"] == 2 and rep["n_fit_h100_80g"] == 2
    perf = tmp_path / "perf"
    hillclimb.OUT_DIR, old = str(perf), hillclimb.OUT_DIR
    try:
        hillclimb.run_cell("qwen", compile_variants=False)
    finally:
        hillclimb.OUT_DIR = old
    text = make_experiments.build(str(tmp_path / "none"), str(dry),
                                  str(perf))
    assert "989 TFLOP/s" in text and "450 GB/s" in text
    assert "v5e" not in text and "197" not in text and "TPU" not in text
    assert "### qwen2.5-32b x decode_32k" in text
    assert "| kimi-k2-1t-a32b | train_4k | 16x16 |" in text
