"""BENCHMARK.json against the benchmark's contract: names, units,
sources, the files each entry names, and the run budget."""

import json
import re

import pytest

from cimbench import check, manifest, runners

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "cimbench/run.py"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_full_check_fits_with_24_cells():
    n = 24
    runs = 2 + 14 * n
    total = runs * (BENCH["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_text(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(cfg):
    assert cfg["file"].startswith("cimbench/configs/")
    doc = json.loads((manifest.ROOT / cfg["file"]).read_text())
    assert doc["name"] == cfg["name"]
    assert doc["reduced"] == cfg["reduced"]
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_files_and_metrics(cell):
    assert cell["chips"] == 1
    assert NAME.match(cell["traffic"])
    traffic = manifest.traffic(cell["traffic"])
    kind = runners.load(traffic["runner"])
    assert callable(kind.Runner) and kind.FAULTS
    assert set(check.limits(cell["name"]))
    e2e = [m["name"] for m in manifest.metrics(BENCH, cell["name"], False)]
    layers = manifest.metrics(BENCH, cell["name"], True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    for m in layers:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", METRICS, ids=lambda e: e["name"])
def test_metric_readers(metric):
    assert callable(manifest.reader(metric["name"]))
    assert set(metric) <= {"name", "unit", "better", "source", "bound",
                           "layer", "moves", "workloads"}
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in [m["name"] for m in BENCH["end_to_end"]]
