"""The port's tile-plan tuner and plan cache against the JAX package, on
the CPU.

* ``plan_tiles`` equals the reference's ``TilePlan`` field for field over
  a hypothesis grid of shapes, modes, branch counts and override triples.
* The plan cache gives the reference's ``lookup`` results on the same
  documents (the reference's device key patched to the port's ``"cpu"``):
  hits, misses, the ``any`` and best-speedup rules, the kill switch,
  corrupt / stale / misaligned files warned once, memo invalidation, and
  the atomic write under an interrupted ``os.replace``.
* The tuner's pieces equal the reference's on the same inputs, with the
  reference's constants patched to the port's where they differ.
* With a cache entry that is not the heuristic's, every path that plans a
  launch (KWN, NLD and stacked ``forward_silicon``, ``fused_seq_vjp``'s
  gradients, ``SNNEventEngine``) gives the no-cache run's bits, and
  ``plan_activity``'s map has the cached grid.
* ``autotune_cell`` / ``tune`` on a tiny cell write entries of the
  reference's schema that ``plan_tiles`` reads back.

While this module runs, hypothesis stores under a temporary directory
(``HYPOTHESIS_STORAGE_DIRECTORY`` and the home directory set for the
module, both restored after it), never in the checkout, and no other
module's examples move.
"""

import json
import os
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from hypothesis import configuration as hyp_configuration
from hypothesis import given, settings, strategies as st

from repro.kernels import fused_macro as j_fused
from repro.launch import hillclimb as j_hill
from repro.roofline import analysis as j_roofline
from repro.tune import autotune as j_auto
from repro.tune import cache as j_cache
from repro.tune import measure as j_measure
from repro_torch.core import ima as t_ima
from repro_torch.core import macro as t_macro
from repro_torch.kernels import fused_macro as t_fused
from repro_torch.kernels import ops as t_ops
from repro_torch.launch import hillclimb as t_hill
from repro_torch.models import snn as t_snn
from repro_torch.serve.engine import EventRequest, SNNEventEngine
from repro_torch.tune import autotune as t_auto
from repro_torch.tune import cache as t_cache
from repro_torch.tune import measure as t_measure

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _hypothesis_home(tmp_path_factory):
    home = tmp_path_factory.mktemp("hypothesis")
    prev_env = os.environ.get("HYPOTHESIS_STORAGE_DIRECTORY")
    prev = getattr(hyp_configuration, "__hypothesis_home_directory")
    os.environ["HYPOTHESIS_STORAGE_DIRECTORY"] = str(home)
    hyp_configuration.set_hypothesis_home_dir(home)
    yield
    hyp_configuration.set_hypothesis_home_dir(prev)
    if prev_env is None:
        os.environ.pop("HYPOTHESIS_STORAGE_DIRECTORY", None)
    else:
        os.environ["HYPOTHESIS_STORAGE_DIRECTORY"] = prev_env


@pytest.fixture(autouse=True)
def _clean_cache_state(monkeypatch):
    """No environment or memo leaks between tests, in either package."""
    for name in (t_cache.ENV_PATH, t_cache.ENV_DISABLE, j_cache.ENV_PATH,
                 j_cache.ENV_DISABLE):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(j_cache, "device_kind", lambda: "cpu")
    t_cache.clear_memo()
    j_cache.clear_memo()
    yield
    t_cache.clear_memo()
    j_cache.clear_memo()


# --- plan_tiles --------------------------------------------------------------

@settings(max_examples=400, deadline=None, database=None)
@given(m=st.integers(1, 300), k_dim=st.integers(1, 1100),
       n=st.integers(1, 600), t=st.integers(1, 32),
       mode=st.sampled_from(["kwn", "nld"]), branches=st.integers(1, 4),
       bm=st.sampled_from([None, 8, 16, 24, 32, 64, 128, 256]),
       bk=st.sampled_from([None, 128, 256, 384, 512]),
       bn=st.sampled_from([None, 128, 256, 384]))
def test_plan_tiles_matches_reference(m, k_dim, n, t, mode, branches, bm, bk,
                                      bn):
    nb = branches if mode == "nld" else 1
    nc = nb * n
    kw = dict(mode=mode, n_branches=nb, bm=bm, bk=bk, bn=bn, use_cache=False)
    want = j_fused.plan_tiles(m, k_dim, nc, n, t, **kw)
    got = t_fused.plan_tiles(m, k_dim, nc, n, t, device="cpu", **kw)
    assert tuple(got) == tuple(want)
    assert got._fields == want._fields
    assert got.activity_shape == want.activity_shape


def test_override_disables_the_lookup(tmp_path, monkeypatch):
    path = _write(tmp_path / "c.json",
                  [_entry("64x300x48x48x8", dict(bm=32, bk=128, bn=128))])
    monkeypatch.setenv(t_cache.ENV_PATH, path)
    monkeypatch.setenv(j_cache.ENV_PATH, path)
    for bm, bk, bn in ((64, None, None), (None, 256, None),
                       (None, None, 128)):
        want = j_fused.plan_tiles(64, 300, 48, 48, 8, bm=bm, bk=bk, bn=bn)
        got = t_fused.plan_tiles(64, 300, 48, 48, 8, bm=bm, bk=bk, bn=bn,
                                 device="cpu")
        assert tuple(got) == tuple(want)
        assert (got.bm, got.bk) != (32, 128)
    hit = t_fused.plan_tiles(64, 300, 48, 48, 8, device="cpu")
    assert tuple(hit) == tuple(j_fused.plan_tiles(64, 300, 48, 48, 8))
    assert (hit.bm, hit.bk) == (32, 128)
    assert tuple(t_fused.plan_tiles(64, 300, 48, 48, 8, device="cpu",
                                    use_cache=False)) == \
        tuple(j_fused.plan_tiles(64, 300, 48, 48, 8, use_cache=False))


# --- the plan cache -------------------------------------------------------------

def _entry(shape, plan, bucket="any", speedup=1.0, device="cpu", mode="kwn",
           **extra):
    return dict({"op": "fused_macro_seq", "shape": shape, "mode": mode,
                 "density_bucket": bucket, "device_kind": device,
                 "plan": plan, "speedup_vs_heuristic": speedup}, **extra)


def _write(path, entries, version=1, fmt="neudw-plan-cache") -> str:
    Path(path).write_text(json.dumps({"format": fmt, "version": version,
                                      "entries": entries}))
    return str(path)


def _both(path, m, k_dim, nc, n, t, **kw):
    """(port, reference) lookups of one launch, warnings recorded."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = t_cache.lookup(m, k_dim, nc, n, t, device="cpu", path=path,
                             **kw)
        want = j_cache.lookup(m, k_dim, nc, n, t, path=path, **kw)
    n_warn = sum(issubclass(w.category, RuntimeWarning) for w in rec)
    return got, want, n_warn


P1 = dict(bm=32, bk=128, bn=128)
P2 = dict(bm=64, bk=256, bn=128)
P3 = dict(bm=16, bk=128, bn=256)


def test_default_file_and_environment_are_the_ports_own():
    assert os.path.basename(t_cache.default_path()) == \
        "PLAN_CACHE_fused_macro_torch.json"
    assert os.path.dirname(t_cache.default_path()) == str(ROOT)
    assert t_cache.default_path() != j_cache.default_path()
    assert t_cache.ENV_PATH != j_cache.ENV_PATH
    assert t_cache.ENV_DISABLE != j_cache.ENV_DISABLE
    assert (t_cache.CACHE_FORMAT, t_cache.CACHE_VERSION) == \
        (j_cache.CACHE_FORMAT, j_cache.CACHE_VERSION)
    assert (t_cache.DENSITY_EDGES, t_cache.DENSITY_BUCKETS,
            t_cache.ANY_BUCKET, t_cache.REQUIRED_ENTRY_FIELDS) == \
        (j_cache.DENSITY_EDGES, j_cache.DENSITY_BUCKETS,
         j_cache.ANY_BUCKET, j_cache.REQUIRED_ENTRY_FIELDS)
    # no cache is committed: every default lookup is a silent miss
    assert not os.path.exists(t_cache.default_path())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert t_cache.lookup(128, 256, 128, 128, 32, device="cpu") is None


@pytest.mark.parametrize("d", [0.0, 0.01, 0.02, 0.05, 0.0749, 0.075, 0.2,
                               0.35, 0.5, 0.75, 1.0])
def test_density_bucket_matches_reference(d):
    assert t_cache.density_bucket(d) == j_cache.density_bucket(d)


def test_lookup_rules_match_reference(tmp_path):
    path = _write(tmp_path / "c.json", [
        _entry("64x300x48x48x8", P1, "d02-07", 1.2),
        _entry("64x300x48x48x8", P2, "d07-15", 1.5),
        _entry("64x300x48x48x8", P3, "d15-35", 1.5),
        _entry("16x128x128x128x4", P1, "any", 1.0),
        _entry("16x128x128x128x4", P2, "d02-07", 3.0),
        _entry("64x300x96x48x8", P3, "any", 1.1, mode="nld"),
        _entry("64x300x48x48x8", P2, "any", 9.9, device="nvidia h100"),
    ])
    cases = [
        ((64, 300, 48, 48, 8), dict(density=0.05)),     # exact bucket
        ((64, 300, 48, 48, 8), dict(density=0.1)),
        ((64, 300, 48, 48, 8), dict(density=0.5)),      # no bucket, no any
        ((64, 300, 48, 48, 8), dict()),                 # best speedup, tie
        ((16, 128, 128, 128, 4), dict()),               # any first
        ((16, 128, 128, 128, 4), dict(density=0.05)),   # bucket over any
        ((16, 128, 128, 128, 4), dict(density=0.9)),    # falls back to any
        ((64, 300, 96, 48, 8), dict(mode="nld")),
        ((64, 300, 96, 48, 8), dict()),                 # kwn: miss
        ((64, 300, 48, 48, 16), dict()),                # other shape: miss
        ((64, 300, 48, 48, 8), dict(op="other")),
    ]
    seen = set()
    for args, kw in cases:
        got, want, n_warn = _both(path, *args, **kw)
        assert got == want, (args, kw)
        assert n_warn == 0
        seen.add(got)
    assert {None, (32, 128, 128), (64, 256, 128), (16, 128, 256)} <= seen
    # the tie at speedup 1.5 goes to the larger bucket name, d15-35
    assert _both(path, 64, 300, 48, 48, 8)[0] == (16, 128, 256)


def test_device_key(tmp_path, monkeypatch):
    path = _write(tmp_path / "c.json", [
        _entry("8x128x128x128x4", P1, device="nvidia h100 80gb hbm3")])
    # a CPU lookup neither hits the card's entry nor touches CUDA
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: pytest.fail("CUDA touched"))
    assert t_cache.device_kind("cpu") == "cpu"
    assert t_cache.device_kind(torch.device("cpu")) == "cpu"
    assert t_cache.lookup(8, 128, 128, 128, 4, device="cpu",
                          path=path) is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert t_cache.device_kind("cuda") == "nvidia h100 80gb hbm3"
    assert t_cache.lookup(8, 128, 128, 128, 4, device="cuda",
                          path=path) == (32, 128, 128)
    assert t_cache.lookup(8, 128, 128, 128, 4, path=path) == (32, 128, 128)


def test_kill_switches_are_independent(tmp_path, monkeypatch):
    path = _write(tmp_path / "c.json", [_entry("8x128x128x128x4", P1)])
    assert _both(path, 8, 128, 128, 128, 4)[:2] == ((32, 128, 128),) * 2
    for value in ("0", "off", "OFF", ""):
        monkeypatch.setenv(t_cache.ENV_DISABLE, value)
        monkeypatch.setenv(j_cache.ENV_DISABLE, value)
        assert _both(path, 8, 128, 128, 128, 4)[:2] == (None, None)
    monkeypatch.delenv(t_cache.ENV_DISABLE)
    assert _both(path, 8, 128, 128, 128, 4)[:2] == ((32, 128, 128), None)
    monkeypatch.setenv(j_cache.ENV_PATH, path)
    monkeypatch.delenv(j_cache.ENV_DISABLE)
    monkeypatch.setenv(t_cache.ENV_DISABLE, "0")
    assert t_cache.lookup(8, 128, 128, 128, 4, device="cpu") is None
    assert j_cache.lookup(8, 128, 128, 128, 4) == (32, 128, 128)


@pytest.mark.parametrize("kind", ["corrupt", "not_cache", "stale_version",
                                  "entries_not_list", "misaligned",
                                  "missing_fields"])
def test_bad_files_warn_once_and_fall_back(tmp_path, kind):
    p = tmp_path / "c.json"
    good = _entry("8x128x128x128x4", P1)
    if kind == "corrupt":
        p.write_text("{not json")
    elif kind == "not_cache":
        _write(p, [good], fmt="something-else")
    elif kind == "stale_version":
        _write(p, [good], version=2)
    elif kind == "entries_not_list":
        p.write_text(json.dumps({"format": "neudw-plan-cache", "version": 1,
                                 "entries": {}}))
    elif kind == "misaligned":
        _write(p, [_entry("8x128x128x128x4", dict(bm=12, bk=128, bn=128))])
    else:
        _write(p, [{"op": "fused_macro_seq", "shape": "8x128x128x128x4"}])
    first = _both(str(p), 8, 128, 128, 128, 4)
    again = _both(str(p), 8, 128, 128, 128, 4)
    assert first[:2] == again[:2] == (None, None)
    # one warning from each package the first time, none after
    assert (first[2], again[2]) == (2, 0)


@pytest.mark.parametrize("plan,nc,ok", [
    (dict(bm=8, bk=128, bn=128), 128, True),
    (dict(bm=4, bk=128, bn=128), 128, False),
    (dict(bm=8, bk=96, bn=128), 128, False),
    (dict(bm=8, bk=128, bn=100), 64, True),       # bn >= nc collapses
    (dict(bm=8, bk=128, bn=100), 200, False),
    (dict(bm=8, bk=128, bn=100), None, True),
    (dict(bm=0, bk=128, bn=128), 128, False),
    (dict(bm="x", bk=128, bn=128), 128, False),
    (dict(bm=8, bk=128), 128, False),
])
def test_valid_blocks_match_reference(plan, nc, ok):
    assert t_cache._valid_blocks(plan, nc=nc) == \
        j_cache._valid_blocks(plan, nc=nc) == ok


def test_memo_invalidates_on_rewrite(tmp_path, monkeypatch):
    p = tmp_path / "c.json"
    _write(p, [_entry("8x128x128x128x4", P1)])
    assert _both(str(p), 8, 128, 128, 128, 4)[:2] == ((32, 128, 128),) * 2
    _write(p, [_entry("8x128x128x128x4", P3, note="longer file")])
    st_ = os.stat(p)
    os.utime(p, ns=(st_.st_atime_ns, st_.st_mtime_ns + 10 ** 9))
    assert _both(str(p), 8, 128, 128, 128, 4)[:2] == ((16, 128, 256),) * 2
    # an unchanged file is served from the memo
    calls = []
    real = json.load
    monkeypatch.setattr(json, "load", lambda f: calls.append(1) or real(f))
    assert _both(str(p), 8, 128, 128, 128, 4)[:2] == ((16, 128, 256),) * 2
    assert calls == []


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_save_entries_merge_and_atomic_write(tmp_path, monkeypatch, pkg):
    mod = t_cache if pkg == "port" else j_cache
    p = tmp_path / "c.json"
    e1 = _entry("8x128x128x128x4", P1)
    e2 = _entry("16x128x128x128x4", P2)
    mod.save_entries([e1], path=str(p))
    mod.save_entries([e2], path=str(p))
    doc = json.loads(p.read_text())
    assert [e["shape"] for e in doc["entries"]] == \
        ["16x128x128x128x4", "8x128x128x128x4"]
    mod.save_entries([e2], path=str(p), merge=False)
    assert len(json.loads(p.read_text())["entries"]) == 1
    with pytest.raises(ValueError):
        mod.save_entries([dict(e1, plan=dict(bm=12, bk=128, bn=128))],
                         path=str(p))
    with pytest.raises(ValueError):
        mod.save_entries([{"op": "fused_macro_seq"}], path=str(p))
    before = p.read_text()

    def boom(src, dst):
        raise OSError("interrupted")

    with monkeypatch.context() as mp:
        mp.setattr(os, "replace", boom)
        with pytest.raises(OSError):
            mod.save_entries([e1], path=str(p))
    assert p.read_text() == before
    assert sorted(x.name for x in tmp_path.iterdir()) == ["c.json"]


def test_save_entries_writes_the_reference_document(tmp_path):
    entries = [_entry("8x128x128x128x4", P1, "d02-07", 1.1),
               _entry("16x128x128x128x4", P2)]
    t_cache.save_entries(entries, path=str(tmp_path / "t.json"))
    j_cache.save_entries(entries, path=str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()


# --- the tuner's pieces ---------------------------------------------------------

CELLS = (t_auto.CANONICAL_CELLS
         + (t_auto.TuneCell(64, 512, 128, 128, 8, 0.02),
            t_auto.TuneCell(64, 300, 200, 200, 8, 0.2),
            t_auto.TuneCell(13, 1000, 640, 640, 3, 0.5),
            t_auto.TuneCell(16, 128, 128, 128, 4, 0.05)))


def _jcell(c):
    return j_auto.TuneCell(*c)


def test_constants_and_cells_match_reference():
    assert t_auto.CANONICAL_CELLS == tuple(
        tuple(c) for c in j_auto.CANONICAL_CELLS)
    assert (t_auto.K_WIN, t_auto.CODE_BITS, t_auto.DRIVE_GAIN,
            t_auto.OBJECTIVES) == (j_auto.K_WIN, j_auto.CODE_BITS,
                                   j_auto.DRIVE_GAIN, j_auto.OBJECTIVES)
    assert t_measure.IN_BURST_DENSITY == j_measure.IN_BURST_DENSITY
    # the prior's rates: the H100's int8 peak and HBM bandwidth
    assert t_auto.roofline.PEAK_INT8_OPS == 1979e12
    assert t_auto.roofline.HBM_BW == 3.35e12


@pytest.mark.parametrize("cell", CELLS, ids=str)
def test_enumerate_candidates_is_the_references_per_launch(cell):
    want = j_auto.enumerate_candidates(_jcell(cell))
    got = t_auto.enumerate_candidates(cell)
    assert set(got) <= set(want)
    assert t_auto.heuristic_blocks(cell) == j_auto.heuristic_blocks(
        _jcell(cell))
    assert t_auto.heuristic_blocks(cell) in got
    keys = [t_auto.launch_key(t_auto._plan(cell, b)) for b in got]
    assert len(set(keys)) == len(keys)              # one per launch
    assert set(keys) == {t_auto.launch_key(t_auto._plan(cell, b))
                         for b in want}             # and every launch


def test_enumerate_candidates_rejects_a_refused_plan(monkeypatch):
    def refuse(plan):
        if plan.bm == 64:
            raise ValueError("refused")

    monkeypatch.setattr(t_fused, "check_plan", refuse)
    with pytest.raises(ValueError, match="refused"):
        t_auto.enumerate_candidates(t_auto.CANONICAL_CELLS[0])


@pytest.mark.parametrize("cell", CELLS, ids=str)
def test_occupied_fraction_and_prior_match_reference(cell, monkeypatch):
    monkeypatch.setattr(j_roofline, "PEAK_FLOPS",
                        t_auto.roofline.PEAK_INT8_OPS)
    monkeypatch.setattr(j_roofline, "HBM_BW", t_auto.roofline.HBM_BW)
    monkeypatch.setattr(j_auto, "GRID_ITER_OVERHEAD_S", 0.0)
    launch = t_auto.LAUNCH_FLOOR_S * t_auto.KERNELS_PER_LAUNCH
    for blocks in j_auto.enumerate_candidates(_jcell(cell)):
        bm, bk = t_auto._plan(cell, blocks)[:2]
        assert t_auto.occupied_fraction(cell.density, bm, bk, cell.t) == \
            j_auto.occupied_fraction(cell.density, bm, bk, cell.t)
        assert t_auto.prior_seconds(cell, blocks) == \
            j_auto.prior_seconds(_jcell(cell), blocks) + launch


@pytest.mark.parametrize("cell", CELLS[:2] + CELLS[-3:], ids=str)
def test_modeled_pj_per_sop_matches_reference(cell):
    x = t_measure.event_stream(3, cell.density, (cell.t, cell.m, cell.k_dim))
    for blocks in t_auto.enumerate_candidates(cell):
        for adc in (0.0, 4.25, 31.0):
            assert t_auto.modeled_pj_per_sop(cell, blocks, x, adc) == \
                j_auto.modeled_pj_per_sop(_jcell(cell), blocks, x, adc)
            assert t_auto.modeled_pj_per_sop(
                cell, blocks, torch.from_numpy(x), adc) == \
                j_auto.modeled_pj_per_sop(_jcell(cell), blocks, x, adc)


def test_score_and_any_entries_match_reference():
    heur = t_auto.Measurement((128, 256, 128), 2.0, 3.0)
    meas = t_auto.Measurement((64, 256, 128), 1.5, 3.5)
    jh = j_auto.Measurement(*heur)
    jm = j_auto.Measurement(*meas)
    for obj in t_auto.OBJECTIVES:
        for w in (0.0, 0.3, 1.0):
            assert t_auto._score(meas, heur, obj, w) == \
                j_auto._score(jm, jh, obj, w)
    entries = [
        _entry("8x128x128x128x4", P1, "d02-07", 1.2),
        _entry("8x128x128x128x4", P2, "d00-02", 1.2),
        _entry("8x128x128x128x4", P3, "d15-35", 1.1),
        _entry("16x128x128x128x4", P1, "d02-07", 0.9),
        _entry("16x128x128x128x4", P1, "d02-07", 2.0, device="gpu"),
    ]
    assert t_auto._any_entries(entries) == j_auto._any_entries(entries)
    assert [e["density_bucket"] for e in t_auto._any_entries(entries)] == \
        ["any"] * 3


@pytest.mark.parametrize("patience", [None, 1, 2, 5])
def test_prior_guided_search_matches_reference(patience):
    rs = np.random.RandomState(0)
    cands = [tuple(int(v) for v in rs.randint(0, 9, 3)) for _ in range(30)]
    score = {c: float(rs.rand()) for c in cands}
    prior = {c: float(rs.rand()) for c in cands}
    for better in (None, lambda a, b: a > b):
        got = t_hill.prior_guided_search(
            cands, score.__getitem__, prior=prior.__getitem__,
            better=better, patience=patience)
        want = j_hill.prior_guided_search(
            cands, score.__getitem__, prior=prior.__getitem__,
            better=better, patience=patience)
        assert got == want
    assert t_hill.prior_guided_search(cands, score.__getitem__) == \
        j_hill.prior_guided_search(cands, score.__getitem__)


@pytest.mark.parametrize("density", [0.005, 0.01, 0.05, 0.19, 0.2, 0.5])
@pytest.mark.parametrize("shape", [(32, 16, 128), (4, 13, 300), (64, 256)],
                             ids=str)
def test_event_stream_on_jax_draws_is_the_references(shape, density):
    key = jax.random.PRNGKey(int(density * 1000) + len(shape))
    k_val, k_el, k_step = jax.random.split(key, 3)
    tern = np.asarray(jax.random.randint(k_val, shape, -1, 2)
                      .astype(np.int8))
    u_el = np.asarray(jax.random.uniform(k_el, shape))
    u_step = np.asarray(jax.random.uniform(k_step, (shape[0], 1, 1)))
    want = np.asarray(j_measure.event_stream(key, density, shape))
    got = t_measure.event_stream_from_draws(tern, u_el, u_step, density)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert np.isin(got, (-1, 0, 1)).all()


def test_event_stream_is_seeded_and_bursty():
    a = t_measure.event_stream(5, 0.05, (64, 8, 256))
    b = t_measure.event_stream(np.random.RandomState(5), 0.05, (64, 8, 256))
    np.testing.assert_array_equal(a, b)
    active = (a != 0).any(axis=(1, 2))
    assert 0 < active.sum() < a.shape[0]       # silent and active steps
    assert abs((a != 0).mean() - 0.05) < 0.03


def test_median_us_times_the_calls_and_emits_a_span():
    from repro_torch.obs import trace as obs_trace
    tracer = obs_trace.Tracer(enabled=True)
    prev = obs_trace.set_tracer(tracer)
    calls = []
    try:
        us = t_measure.median_us(lambda x: calls.append(1) or x * 2,
                                 (torch.ones(4),), iters=5, label="probe")
    finally:
        obs_trace.set_tracer(prev)
    assert len(calls) == 6 and us > 0.0
    spans = [s for s in tracer.spans() if s[0] == "probe"]
    assert len(spans) == 1
    assert t_measure.median_ms(lambda: None, (), iters=3) >= 0.0


# --- a non-heuristic cached plan leaves every output alone ---------------------

def _cache_for(tmp_path, monkeypatch, entries):
    path = _write(tmp_path / "plan_cache.json", entries)
    monkeypatch.setenv(t_cache.ENV_PATH, path)
    t_cache.clear_memo()
    return path


def _no_cache(monkeypatch):
    monkeypatch.setenv(t_cache.ENV_DISABLE, "0")


def _events(b, t, n_in, seed, rate=0.1):
    rs = np.random.RandomState(seed)
    return rs.choice([-1.0, 0.0, 1.0], p=[rate / 2, 1 - rate, rate / 2],
                     size=(b, t, n_in)).astype(np.float32)


SNN_KW = dict(n_in=300, n_hidden=48, n_classes=5, n_steps=10, k=6)


@pytest.mark.parametrize("mode", ["kwn", "nld"])
@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
def test_cached_plan_leaves_forward_silicon_bitwise(tmp_path, monkeypatch,
                                                    mode, noisy):
    cfg = t_snn.SNNConfig(mode=mode, **SNN_KW)
    p = t_snn.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    ev = _events(64, 10, cfg.n_in, seed=1)
    noise = t_ima.IMANoiseModel() if noisy else None
    nc = cfg.n_hidden * (cfg.n_branches if mode == "nld" else 1)
    shape = f"64x{cfg.n_in}x{nc}x{cfg.n_hidden}x10"
    fw = t_snn.pack_fused(p, cfg, noise)
    heur = t_macro.plan_fused_tiles(64, fw, cfg.n_hidden, 10)
    _no_cache(monkeypatch)
    base = t_snn.forward_silicon(p, ev, cfg, seed=9, noise=noise,
                                 device="cpu")
    monkeypatch.delenv(t_cache.ENV_DISABLE)
    _cache_for(tmp_path, monkeypatch, [
        _entry(shape, dict(bm=32, bk=128, bn=128), mode=mode)])
    plan = t_macro.plan_fused_tiles(64, fw, cfg.n_hidden, 10)
    assert (heur.bm, heur.bk) == (64, 256)
    assert (plan.bm, plan.bk) == (32, 128)
    act = t_macro.plan_activity(torch.from_numpy(ev).transpose(0, 1), fw,
                                cfg.n_hidden)
    assert tuple(act.shape) == plan.activity_shape == (10, 2, 3)
    tuned = t_snn.forward_silicon(p, ev, cfg, seed=9, noise=noise,
                                  device="cpu")
    assert torch.equal(base[0], tuned[0])
    for key in ("adc_steps", "lif_updates", "sops"):
        assert torch.equal(base[1][key], tuned[1][key]), key
    # the skipped-block ratio is the plan's own gating granularity
    assert 0.0 <= float(tuned[1]["skipped_block_ratio"][0]) <= 1.0


def test_cached_plan_leaves_the_stack_bitwise(tmp_path, monkeypatch):
    cfg = t_snn.SNNConfig(n_in=300, n_classes=5, n_steps=10,
                          hidden_layers=(160, 48), k_layers=(8, 6))
    p = t_snn.init_params(cfg, torch.Generator().manual_seed(2),
                          device="cpu")
    ev = _events(64, 10, cfg.n_in, seed=3)
    outs = []
    for cached in (False, True):
        if cached:
            monkeypatch.delenv(t_cache.ENV_DISABLE)
            _cache_for(tmp_path, monkeypatch, [
                _entry("64x300x160x160x10", dict(bm=32, bk=128, bn=128)),
                _entry("64x160x48x48x10", dict(bm=32, bk=128, bn=128))])
        else:
            _no_cache(monkeypatch)
        for noise in (None, t_ima.IMANoiseModel()):
            outs.append(t_snn.forward_silicon(p, ev, cfg, seed=4,
                                              noise=noise, device="cpu"))
        stack = t_snn.pack_fused_stack(p, cfg)
        spec = t_fused.plan_tiles(64, 300, 160, 160, 10, device="cpu")
        *_, specs, plan0 = t_ops.stack_operands(
            torch.from_numpy(ev).transpose(0, 1),
            [(fw.msb, fw.lsb, fw.boundaries, fw.levels, fw.scale)
             for fw in stack], [torch.zeros(64, w) for w in (160, 48)],
            ks=(8, 6), device="cpu")
        want_bk = (128, 128) if cached else (256, 160)
        assert (plan0.bm, specs[0].bk, specs[1].bk) == \
            ((32,) if cached else (64,)) + want_bk
        assert spec.bm == plan0.bm
    for a, b in zip(outs[:2], outs[2:]):
        assert torch.equal(a[0], b[0])
        for key in ("adc_steps", "lif_updates", "sops"):
            assert torch.equal(a[1][key], b[1][key]), key


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("gate", [True, False])
def test_cached_plan_leaves_fused_seq_vjp_gradients_bitwise(
        tmp_path, monkeypatch, remat, gate):
    rs = np.random.RandomState(5)
    t, m, kdim, n = 8, 64, 300, 48
    x = torch.from_numpy(rs.choice([-1.0, 0.0, 1.0], p=[0.05, 0.9, 0.05],
                                   size=(t, m, kdim)).astype(np.float32))
    w0 = torch.from_numpy(rs.uniform(-3.4, 3.4, (kdim, n)).astype(np.float32))
    v0_ = torch.from_numpy(rs.uniform(-0.5, 1.0, (m, n)).astype(np.float32))
    scale = torch.from_numpy(rs.uniform(0.02, 0.1, n).astype(np.float32))
    cfg = t_macro.CIMMacroConfig(code_bits=5, mac_range=24.0,
                                 ima_noise=t_ima.IMANoiseModel())
    g_spk = torch.from_numpy(rs.randn(t, m, n).astype(np.float32))
    g_v = torch.from_numpy(rs.randn(m, n).astype(np.float32))
    res = []
    for cached in (False, True):
        if cached:
            monkeypatch.delenv(t_cache.ENV_DISABLE)
            _cache_for(tmp_path, monkeypatch, [
                _entry(f"{m}x{kdim}x{n}x{n}x{t}",
                       dict(bm=32, bk=128, bn=128))])
            assert t_fused.plan_tiles(m, kdim, n, n, t,
                                      device="cpu").bm == 32
        else:
            _no_cache(monkeypatch)
        w = w0.clone().requires_grad_()
        v0 = v0_.clone().requires_grad_()
        spk, v_out = t_macro.fused_seq_vjp(
            x, w, scale, cfg, v0, k=6, drive_gain=0.25, snl_amp=0.05,
            kwn_relax=0.1, remat=remat, gate=gate, seed=11)
        (spk * g_spk).sum().add((v_out * g_v).sum()).backward()
        res.append((spk.detach(), v_out.detach(), w.grad, v0.grad))
    for name, a, b in zip(("spikes", "v_out", "dW", "dv0"), *res):
        assert torch.equal(a, b), name


def test_cached_plan_leaves_the_engine_bitwise(tmp_path, monkeypatch):
    cfg = t_snn.SNNConfig(**SNN_KW)
    p = t_snn.init_params(cfg, torch.Generator().manual_seed(6),
                          device="cpu")
    rs = np.random.RandomState(7)
    traffic = [_events(1, int(rs.randint(3, 14)), cfg.n_in, seed=i,
                       rate=(0.02, 0.1, 0.3)[i % 3])[0] for i in range(20)]
    served = []
    for cached in (False, True):
        if cached:
            monkeypatch.delenv(t_cache.ENV_DISABLE)
            _cache_for(tmp_path, monkeypatch, [
                _entry(f"16x{cfg.n_in}x48x48x4",
                       dict(bm=8, bk=128, bn=128))])
            assert tuple(t_fused.plan_tiles(16, cfg.n_in, 48, 48, 4,
                                            device="cpu")[:2]) == (8, 128)
        else:
            _no_cache(monkeypatch)
        for noise in (None, t_ima.IMANoiseModel()):
            eng = SNNEventEngine(cfg, p, batch_slots=16, round_steps=4,
                                 seed=3, noise=noise, device="cpu")
            reqs = [eng.submit(EventRequest(uid=i, events=ev))
                    for i, ev in enumerate(traffic)]
            eng.run()
            served.append([(r.logits, r.pred, r.adc_steps, r.sops)
                           for r in reqs])
    for base, tuned in zip(served[:2], served[2:]):
        for (la, pa, aa, sa), (lb, pb, ab, sb) in zip(base, tuned):
            assert torch.equal(la, lb)
            assert (pa, aa, sa) == (pb, ab, sb)


# --- the tuner end to end on the CPU ----------------------------------------------

def test_autotune_and_tune_write_the_reference_schema(tmp_path, monkeypatch):
    cell = t_auto.TuneCell(64, 256, 128, 128, 4, 0.05)
    entry = t_auto.autotune_cell(cell, iters=1, verbose=False, device="cpu")
    ref_doc = json.loads((ROOT / "PLAN_CACHE_fused_macro.json").read_text())
    assert set(entry) == set(ref_doc["entries"][0])
    assert entry["device_kind"] == "cpu"
    assert entry["shape"] == "64x256x128x128x4"
    assert entry["density_bucket"] == "d02-07"
    assert entry["n_candidates"] == len(t_auto.enumerate_candidates(cell))
    assert entry["n_candidates"] == 4
    assert tuple(entry["plan"].values()) in t_auto.enumerate_candidates(cell)
    assert entry["speedup_vs_heuristic"] > 0.0

    path = str(tmp_path / "tuned.json")
    cells = (cell, cell._replace(density=0.2))
    entries, out = t_auto.tune(cells, iters=1, path=path, verbose=False,
                               device="cpu")
    assert out == path and len(entries) == 3
    doc = json.loads(Path(path).read_text())
    assert (doc["format"], doc["version"]) == ("neudw-plan-cache", 1)
    assert {e["density_bucket"] for e in doc["entries"]} == \
        {"d02-07", "d15-35", "any"}
    monkeypatch.setenv(t_cache.ENV_PATH, path)
    t_cache.clear_memo()
    for e in entries:
        d = {"d02-07": 0.05, "d15-35": 0.2, "any": None}[e["density_bucket"]]
        plan = t_fused.plan_tiles(64, 256, 128, 128, 4, density=d,
                                  device="cpu")
        assert (plan.bm, plan.bk, plan.bn) == tuple(e["plan"].values())
    # the reference reads the port's document (keyed "cpu") the same way
    assert j_cache.lookup(64, 256, 128, 128, 4, path=path) == \
        t_cache.lookup(64, 256, 128, 128, 4, device="cpu", path=path)
    with pytest.raises(ValueError):
        t_auto.autotune_cell(cell, objective="fast", device="cpu")
