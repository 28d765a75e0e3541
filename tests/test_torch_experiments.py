"""The port's experiment scripts (``experiments_torch``) against the JAX
package's (``benchmarks/``) on the CPU.

The closed-form scripts (Fig. 3d, Fig. 9, the model half of the KWN
latency claims, Table I's energy fields, the K sweep's pJ/SOP) return the
reference's dicts exactly; Fig. 7a's moments are the JAX counter-stream
measurement's.  The trained ones are compared by structure:
with the models' training and evaluation stubbed out on both sides, the
port's scripts return the reference's dicts; and the whole suite runs
end to end through ``experiments_torch.run --device cpu`` at two training
steps and one evaluation batch, every script returning the reference's
keys.  Accuracies are not compared there: the two packages draw other
batches and noise (``experiments_torch/_snn_cache.py``).  On the same
(carried) batches the unstubbed ``eval_model`` evaluates the reference's
path: a model trained a few steps gives clean KWN results equal to the
JAX script's ``eval_model`` bit for bit and NLD within the composed
path's sum-order margin, with the kernel path's results beside them.
"""

import importlib
import importlib.util
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from experiments_torch import _snn_cache as t_cache  # noqa: E402
from experiments_torch import ablation_kwn_lm as t_lm  # noqa: E402
from experiments_torch import run as t_run  # noqa: E402

torch.set_num_threads(1)

NAMES = sorted(t_run.BENCHES)


def _load_reference(name: str):
    path = ROOT / "benchmarks" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name: str):
    return importlib.import_module(f"experiments_torch.{name}")


def _shape(x):
    """The nested keys of a result (list lengths, scalar kinds)."""
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_shape(v) for v in x]
    if isinstance(x, bool):
        return "bool"
    if isinstance(x, (int, float)) or x is None:
        return "number"
    return type(x).__name__


def _stub_models(monkeypatch, cache):
    """Replace training and evaluation in a ``_snn_cache`` module: a
    model is its config, an evaluation a fixed accuracy with the ADC
    steps and LIF updates a K would give."""
    def trained_model(dataset, mode, train_nlq=True, seed=0):
        return None, cache.snn_config(dataset, mode, train_nlq), None

    def eval_model(p, cfg, ds, seed=1, **kw):
        k = kw.get("k") or cfg.k
        acc = 0.5 + 0.01 * k + (0.02 if kw.get("use_snl", True) else 0.0)
        return acc, {"adc_steps": 10.0 + k / 8, "lif_updates": float(k),
                     "sops": 3.0}

    monkeypatch.setattr(cache, "trained_model", trained_model)
    monkeypatch.setattr(cache, "eval_model", eval_model)


@pytest.fixture
def stubbed(monkeypatch):
    ref_cache = importlib.import_module("benchmarks._snn_cache")
    _stub_models(monkeypatch, ref_cache)
    _stub_models(monkeypatch, t_cache)


@pytest.mark.parametrize("name", ["fig3d_weight_impl", "fig9_energy"])
def test_closed_form_scripts_equal_reference(name):
    want = _load_reference(name).run()
    got = _port(name).run()
    assert got == want
    if name == "fig3d_weight_impl":
        assert got["matches_paper"] is True


@pytest.mark.parametrize("name", ["latency_kwn", "ablation_k_sweep",
                                  "fig5b_snl", "fig6c_nlq",
                                  "fig8_accuracy"])
def test_trained_scripts_equal_reference_on_the_same_evaluations(stubbed,
                                                                 name):
    """With the same (stubbed) evaluations on both sides, every field
    equals the reference's: the latency model, the K sweep's pJ/SOP and
    knees, the gains and orderings."""
    want = _load_reference(name).run()
    got = _port(name).run()
    assert got == want
    if name == "latency_kwn":
        assert got["model"]["adc_saving_k12"] == 0.3


def test_table1_energy_fields_equal_reference(stubbed):
    ref_fig8 = importlib.import_module("benchmarks.fig8_accuracy")
    t_fig8 = importlib.import_module("experiments_torch.fig8_accuracy")
    want = _load_reference("table1_comparison").run()
    got = _port("table1_comparison").run()
    assert got == want
    for key in ("ee_kwn_nmnist_pj_sop", "ee_kwn_dvs_pj_sop",
                "ee_nld_pj_sop", "power_mw_modeled"):
        assert got["this_work"][key] == want["this_work"][key]
    assert got["ee_improvement_vs_vlsi25"] == 1.625
    assert ref_fig8.run() == t_fig8.run()


def test_fig7_transfer_error_is_the_counter_stream_measurement(monkeypatch):
    """Fig. 7a's moments are the counter stream's (codes equal to the JAX
    package's bit for bit, f32 moments within 1e-6), and inside the golden
    bands of the Fig. 7a measurement (0.41 +- 0.08, 1.34 +- 0.12 LSB)."""
    from repro.core import ima as j_ima

    monkeypatch.setattr(t_cache, "DEVICE", "cpu")
    got = _port("fig7_ima").run()
    want = j_ima.measure_transfer_error_ctr(j_ima.nlq_codebook(5, -64, 64),
                                            seed=0)
    for name, key in (("nlq_mean_lsb", "mean_lsb"),
                      ("nlq_sigma_lsb", "std_lsb")):
        assert abs(got[name] - want[key]) <= 5e-4 + 1e-6, (name, got, want)
    assert got["nlq_mean_lsb"] == pytest.approx(0.41, abs=0.08)
    assert got["nlq_sigma_lsb"] == pytest.approx(1.34, abs=0.12)
    assert _shape(got) == _shape(_load_reference("fig7_ima").run())


def test_lm_ablation_matches_reference_keys(monkeypatch):
    ref = _load_reference("ablation_kwn_lm")
    monkeypatch.setattr(ref, "_train", lambda cfg, seed=0, steps=40:
                        [5.0, 4.0 + 0.001 * cfg.kwn_ffn_k])
    monkeypatch.setattr(t_lm, "_train", lambda cfg, seed=0, steps=None:
                        [5.0, 4.0 + 0.001 * cfg.kwn_ffn_k])
    monkeypatch.setattr(t_cache, "DEVICE", "cpu")
    want = ref.run()
    got = t_lm.run()
    for key in want:
        if not key.startswith("router") and key != "snl_improves_balance":
            assert got[key] == want[key], key
    assert _shape(got) == _shape(want)
    for key in ("router_aux_balance_no_snl", "router_aux_balance_snl"):
        assert 0.9 < got[key] < 1.6, (key, got[key])


def test_run_smoke_on_cpu_returns_every_reference_key(monkeypatch, tmp_path,
                                                      stubbed):
    """The whole suite through ``run.main --device cpu`` at 2 training
    steps, 1 evaluation batch and 2 LM steps, the cache in ``tmp_path``:
    every script's results JSON has the reference's keys (the reference's
    models stubbed for the comparison), the model files are tagged with
    the device, and a second run reuses them."""
    ref_results = {}
    for name in NAMES:
        ref = _load_reference(name)
        if name == "ablation_kwn_lm":
            monkeypatch.setattr(ref, "_train", lambda cfg, seed=0, steps=40:
                                [5.0, 4.0])
        ref_results[name] = ref.run()
    monkeypatch.undo()
    monkeypatch.setattr(t_cache, "DEVICE", None)     # main sets it
    monkeypatch.setattr(t_cache, "CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(t_cache, "TRAIN_STEPS", 2)
    monkeypatch.setattr(t_cache, "EVAL_BATCHES", 1)
    monkeypatch.setattr(t_lm, "STEPS", 2)
    summary = t_run.main(["--device", "cpu"])
    assert summary["device"] == "cpu"
    assert set(summary["runs"]) == set(NAMES)
    for name in NAMES:
        got = json.loads((tmp_path / "results" / f"{name}.json").read_text())
        assert _shape(got) == _shape(json.loads(json.dumps(
            ref_results[name], default=str))), name
        assert summary["runs"][name]["seconds"] >= 0.0
        assert summary["runs"][name]["launches"] == {
            "fused_macro_seq_kwn": 0, "fused_macro_seq_nld": 0}
    models = sorted(p.name for p in tmp_path.glob("*.npz"))
    assert len(models) == 8 and all(m.endswith("_t2_cpu.npz")
                                    for m in models), models
    sweep = json.loads((tmp_path / "results"
                        / "ablation_k_sweep.json").read_text())
    for ds in ("nmnist", "dvs_gesture"):
        steps = [c["mean_adc_steps"] for c in sweep[ds]]
        assert steps == sorted(steps), (ds, steps)
        assert [c["lif_updates"] for c in sweep[ds]] == [
            float(k) for k in (1, 3, 6, 12, 24, 48)]
    p, cfg, _ = t_cache.trained_model("quiroga", "nld")
    assert cfg.activation == "sigmoid4" and set(p) == {"dend", "w_out"}
    assert len(sorted(tmp_path.glob("*.npz"))) == 8


def test_experiments_import_no_jax_repro_or_benchmarks():
    pattern = re.compile(
        r"^\s*(?:import|from)\s+(jax|jaxlib|repro|benchmarks)\b",
        re.MULTILINE)
    files = sorted((ROOT / "experiments_torch").glob("*.py"))
    assert {p.stem for p in files} >= set(NAMES) | {"_snn_cache", "run"}
    for path in files:
        hits = pattern.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


class _Batches:
    """A dataset that serves the same carried batches to both packages,
    in order, ignoring the key or generator (each evaluation pass of
    ``eval_model`` starts again at the first)."""

    def __init__(self, batches, to, cfg=None, device=None):
        self.batches = [tuple(to(a) for a in b) for b in batches]
        self.cfg, self.device, self.i = cfg, device, 0

    def sample(self, key, batch):
        b = self.batches[self.i % len(self.batches)]
        self.i += 1
        return b


@pytest.mark.parametrize("mode", ["kwn", "nld"])
def test_eval_model_evaluates_the_reference_path(monkeypatch, mode):
    """``eval_model`` on a model trained 3 steps, against the JAX
    script's on the same two batches of 128: the composed chain (clean
    KWN: accuracy bit for bit and the telemetry; NLD: logits within the
    composed path's sum-order tolerance and the same accuracy), and the
    kernel path's accuracy and telemetry as ``kernel_*`` keys (clean KWN:
    equal to the composed chain's)."""
    import jax
    import jax.numpy as jnp

    from repro.core import dendrite as j_dend
    from repro.models import snn as j_snn
    from repro_torch.core import dendrite as t_dend
    from repro_torch.data import events as t_events
    from repro_torch.models import snn as t_snn
    ref_cache = importlib.import_module("benchmarks._snn_cache")
    n_batches = 2
    monkeypatch.setattr(ref_cache, "EVAL_BATCHES", n_batches)
    monkeypatch.setattr(t_cache, "EVAL_BATCHES", n_batches)
    tcfg = t_cache.snn_config("nmnist", mode)
    jcfg = ref_cache.snn_config("nmnist", mode)
    ds = t_events.EventDataset(t_events.DATASETS["nmnist"], device="cpu")
    p, _ = t_snn.train(tcfg, ds, n_steps=3, batch=16, seed=0, lr=0.1,
                       device="cpu")
    gen = torch.Generator().manual_seed(5)
    batches = [tuple(a.numpy() for a in ds.sample(gen, 128))
               for _ in range(n_batches)]
    jp = {k: (j_dend.DendriteParams(*(jnp.asarray(a.numpy()) for a in v))
              if isinstance(v, t_dend.DendriteParams)
              else jnp.asarray(v.numpy())) for k, v in p.items()}

    want_acc, want_tele = ref_cache.eval_model(
        jp, jcfg, _Batches(batches, jnp.asarray))
    evals = []
    got_acc, got_tele = t_run.recorded(t_cache.eval_model, evals)(
        p, tcfg, _Batches(batches, torch.from_numpy, ds.cfg, ds.device))

    for key in ("adc_steps", "lif_updates", "sops"):
        assert got_tele[key] == pytest.approx(want_tele[key], rel=1e-6,
                                              abs=0), key
    assert {"kernel_acc", "kernel_adc_steps", "kernel_lif_updates",
            "kernel_sops", "kernel_skipped_block_ratio"} <= set(got_tele)
    assert evals == [{"dataset": "nmnist", "mode": mode,
                      "k": tcfg.k, "noise": False,
                      "use_snl": tcfg.use_snl, "train_nlq": True,
                      "acc": got_acc, "kernel_acc": got_tele["kernel_acc"]}]
    if mode == "kwn":
        assert got_acc == want_acc
        assert got_tele["kernel_acc"] == got_acc
        assert got_tele["kernel_adc_steps"] == got_tele["adc_steps"]
        return
    # NLD: the branch MACs sum in each library's order, so the logits
    # agree within the composed path's tolerance and the accuracy is the
    # same wherever no row's top two logits lie within it
    gaps = []
    for ev, lab in batches:
        jl, _ = j_snn.forward_silicon(jp, jnp.asarray(ev), jcfg,
                                      jax.random.PRNGKey(0), fused=False)
        tl, _ = t_snn.forward_silicon(p, ev, tcfg, device="cpu",
                                      fused=False)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-6)
        top2 = np.sort(np.asarray(jl), -1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
    near = int((np.concatenate(gaps) <= 2e-5).sum())
    assert abs(got_acc - want_acc) * 128 * n_batches <= near + 1e-9, (
        got_acc, want_acc, near)

