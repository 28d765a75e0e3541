"""A configuration, a traffic mix, a metric, a cell's limits and a kind
of runner dropped into a copy of the benchmark are found by name, and a
run of the new cell reports the new metric, with no other file edited."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

from cimbench import manifest

SRC = Path(__file__).resolve().parents[2] / "src"

RUN = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
import torch
from cimbench import harness, manifest
bench = manifest.load()
cell = manifest.workload(bench, {cell!r})
res = harness.execute(bench, cell, manifest.traffic(cell["traffic"]), 7,
                      0.2, False, torch.device("cpu"), time.perf_counter())
print(json.dumps(res))
"""


KIND = """
\"\"\"Counts its calls: a kind of runner with no model behind it.\"\"\"

FAULTS = {}


class Runner:
    phase = "count"

    def __init__(self, config, traffic, seed, dev):
        self.units, self.calls, self.last = traffic["per_call"], 0, None

    def call(self, i):
        self.calls += 1
        return i

    def keep(self, i, out):
        self.last = out

    def telemetry(self):
        return {}

    def work(self):
        return None

    def numbers(self):
        return {"calls_gap": float(self.last != self.calls - 1)}

    def control_numbers(self):
        return {"calls_gap": 1.0}
"""


def _checkout(tmp_path):
    """A copy of the benchmark, and the bytes of each of its files."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(manifest.BENCH, root / "cimbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "cimbench").rglob("*")
              if p.is_file()}
    return root, root / "cimbench", manifest.load(), before


def _run(root, cell: str) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(root), src=str(SRC),
                                          cell=cell)],
        capture_output=True, text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_new_files_are_found_without_edits(tmp_path):
    root, cb, bench, before = _checkout(tmp_path)
    cfg = json.loads((cb / "configs" / "nmnist-kwn.json").read_text())
    cfg["name"], cfg["snn"]["k"] = "tiny-kwn", 5
    (cb / "configs" / "tiny-kwn.json").write_text(json.dumps(cfg))
    traffic = json.loads((cb / "traffic" / "eval.json").read_text())
    traffic["streams"] = 16
    (cb / "traffic" / "eval-k5.json").write_text(json.dumps(traffic))
    (cb / "metrics" / "passes_in_window.py").write_text(
        "def read(ctx):\n    return float(ctx.window.calls)\n")
    (cb / "limits" / "tiny-kwn.eval-k5.json").write_text(json.dumps(
        {"limits": {"output_gap": 0.0}}))
    bench["configs"].append(dict(bench["configs"][0], name="tiny-kwn",
                                 file="cimbench/configs/tiny-kwn.json"))
    bench["workloads"].append(
        {"name": "tiny-kwn.eval-k5", "config": "tiny-kwn",
         "traffic": "eval-k5", "chips": 1, "why": "a test's cell"})
    for m in bench["end_to_end"]:          # the eval metrics list it
        if "nmnist-kwn.eval" in m.get("workloads", []):
            m["workloads"].append("tiny-kwn.eval-k5")
    bench["end_to_end"].append(
        {"name": "passes_in_window", "unit": "passes", "better": "higher",
         "bound": 0.05, "source": "host_clock",
         "workloads": ["tiny-kwn.eval-k5"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    loaded = manifest.load(root)
    assert manifest.config(loaded, "tiny-kwn", root)["snn"]["k"] == 5
    assert manifest.traffic("eval-k5", cb)["streams"] == 16
    assert callable(manifest.reader("passes_in_window", cb))
    res = _run(root, "tiny-kwn.eval-k5")
    assert res["correct"] is True
    assert res["metrics"]["passes_in_window"]["value"] >= 1
    assert {"setup_s", "eval_streams_per_s", "eval_pass_ms_p95"} \
        <= set(res["metrics"])
    for path, data in before.items():
        assert path.read_bytes() == data, path


def test_a_new_runner_kind_is_found_without_edits(tmp_path):
    root, cb, bench, before = _checkout(tmp_path)
    (cb / "runners" / "count.py").write_text(KIND)
    (cb / "configs" / "counter.json").write_text(json.dumps(
        {"name": "counter", "reduced": []}))
    (cb / "traffic" / "count.json").write_text(json.dumps(
        {"runner": "count", "per_call": 5}))
    (cb / "metrics" / "counted_per_s.py").write_text(
        "def read(ctx):\n    return ctx.window.units_per_s()\n")
    (cb / "limits" / "counter.count.json").write_text(json.dumps(
        {"limits": {"calls_gap": 0.0}}))
    bench["configs"].append({"name": "counter", "source": "a test",
                             "file": "cimbench/configs/counter.json",
                             "reduced": [], "why": "a test's config"})
    bench["workloads"].append(
        {"name": "counter.count", "config": "counter", "traffic": "count",
         "chips": 1, "why": "a test's cell"})
    bench["end_to_end"].append(
        {"name": "counted_per_s", "unit": "units/s", "better": "higher",
         "bound": 0.05, "source": "host_clock",
         "workloads": ["counter.count"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    res = _run(root, "counter.count")
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"setup_s", "counted_per_s"}
    assert res["metrics"]["counted_per_s"]["value"] > 0
    for path, data in before.items():
        assert path.read_bytes() == data, path
