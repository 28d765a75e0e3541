"""The port's serving tools, tuner command line and examples on the CPU.

``tools/chaos_serve_torch.py --smoke``, ``tools/obs_report_torch.py
--smoke`` / ``--check`` / ``--metrics [--prom]`` and
``tools/tune_plans_torch.py --smoke`` with ``--device cpu`` (the plain
versions of the kernels), a violated chaos assertion exiting nonzero, and
the examples ``quickstart_torch.py`` and a few steps of
``train_snn_events_torch.py``.  On the card ``chip_smoke.py`` runs the
three tools' smokes as subprocesses.
"""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from repro_torch.tune import cache as t_cache

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _load(rel: str):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        "_tool_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _no_plan_cache(monkeypatch, tmp_path):
    monkeypatch.setenv(t_cache.ENV_PATH, str(tmp_path / "absent.json"))
    t_cache.clear_memo()
    yield
    t_cache.clear_memo()


def test_chaos_smoke_holds_on_cpu(capsys):
    chaos = _load("tools/chaos_serve_torch.py")
    assert chaos.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name in chaos.SCENARIOS:
        assert f"[chaos] {name:16s} ok" in out
    assert "all 5 scenarios hold on cpu" in out


def test_chaos_violation_exits_nonzero(monkeypatch, capsys):
    chaos = _load("tools/chaos_serve_torch.py")

    def broken(rng, smoke):
        raise AssertionError("served logits != one-shot (bitwise)")

    monkeypatch.setitem(chaos.SCENARIOS, "malformed", broken)
    assert chaos.main(["--smoke", "--device", "cpu",
                       "--scenario", "malformed"]) == 1
    assert "FAIL" in capsys.readouterr().out


def test_obs_smoke_and_subcommands_on_cpu(tmp_path, capsys):
    obs = _load("tools/obs_report_torch.py")
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.json"
    assert obs.main(["--smoke", "--device", "cpu", "--trace-out", str(trace),
                     "--metrics-out", str(metrics)]) == 0
    assert "[obs-smoke] ok on cpu" in capsys.readouterr().out
    assert obs.check_trace(str(trace)) == []
    assert obs.main(["--check", str(trace)]) == 0
    assert obs.main(["--metrics", str(metrics)]) == 0
    assert obs.main(["--metrics", str(metrics), "--prom"]) == 0
    out = capsys.readouterr().out
    assert "# TYPE terminal_total counter" in out
    assert 'terminal_total{state="completed"} 6' in out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "X", "ts": -1}]}))
    assert obs.main(["--check", str(bad)]) == 1
    assert obs.main([]) == 2


def test_tune_smoke_round_trips_on_cpu(tmp_path, capsys):
    tune = _load("tools/tune_plans_torch.py")
    out = tmp_path / "plans.json"
    assert tune.main(["--smoke", "--device", "cpu", "--out", str(out)]) == 0
    assert "tune-smoke OK on cpu" in capsys.readouterr().out
    doc = json.loads(out.read_text())
    assert {e["device_kind"] for e in doc["entries"]} == {"cpu"}
    assert {e["shape"] for e in doc["entries"]} == {"16x128x128x128x4"}
    # one explicit cell, merged into the same file
    assert tune.main(["--cell", "64x256x128x128x4", "--density", "0.2",
                      "--iters", "1", "--patience", "1", "--device", "cpu",
                      "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert {e["shape"] for e in doc["entries"]} == \
        {"16x128x128x128x4", "64x256x128x128x4"}


def test_quickstart_runs_both_modes_on_cpu(capsys):
    _load("examples/quickstart_torch.py").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 0 winners equal the composed ones: True" in out
    assert "fused NLD sequence" in out
    assert "1.6x-vs-SOTA check" in out


def test_snn_example_fine_tunes_and_serves_on_cpu(capsys):
    _load("examples/train_snn_events_torch.py").main(
        ["--device", "cpu", "--steps", "2", "--silicon-steps", "2",
         "--serve-requests", "4"])
    out = capsys.readouterr().out
    assert "silicon fine-tune (2 steps, noise-aware QAT)" in out
    assert "serve[clean]: 4 requests" in out
    assert "serve[noisy]: 4 requests" in out
    assert "nmnist NLD" in out
