"""The rest of a run, the look for a card skipped, with the timed path
broken underneath: ``correct`` comes out false for every fault the cell's
runner kind can have, also where the fault starts only with the measured
window, and true without one."""

import time

import pytest
import torch

from cimbench import harness, manifest, runners

BENCH = manifest.load()
SMALL = {"eval": {"streams": 24, "test_sets": 3},
         "train": {"batch": 16, "batches": 4}}


def kind_of(cell: str) -> str:
    return manifest.traffic(manifest.workload(BENCH, cell)["traffic"])[
        "runner"]


CASES = [(w["name"], f) for w in BENCH["workloads"]
         for f in runners.load(kind_of(w["name"])).FAULTS]


def run(cell_name: str) -> dict:
    cell = manifest.workload(BENCH, cell_name)
    traffic = dict(manifest.traffic(cell["traffic"]))
    traffic.update(SMALL[traffic["runner"]])
    return harness.execute(BENCH, cell, traffic, 4_000_000_007, 0.05, False,
                           torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault):
    with runners.load(kind_of(cell)).FAULTS[fault]():
        res = run(cell)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_fault_from_the_window_on_is_not_correct(cell, fault,
                                                   monkeypatch):
    """Set-up and its warm-up are sound; the window's calls are not, as
    under a cache or a plan that a change builds only after warm-up."""
    planted = runners.load(kind_of(cell)).FAULTS[fault]
    window = harness.run_window

    def broken_window(*args, **kw):
        with planted():
            return window(*args, **kw)

    monkeypatch.setattr(harness, "run_window", broken_window)
    res = run(cell)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_the_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
