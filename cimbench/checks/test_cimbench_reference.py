"""The reference against the port's CPU path at a small size, and the
control (the reference on TF32 products) caught by every cell's limits.

The control runs on the CPU here and, marked ``cuda``, on the card."""

import pytest
import torch

from cimbench import check, manifest, runners

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]


def small(cell: str):
    w = manifest.workload(BENCH, cell)
    traffic = dict(manifest.traffic(w["traffic"]))
    if traffic["runner"] == "eval":
        traffic["streams"], traffic["test_sets"] = 40, 2
    else:
        traffic["batch"], traffic["batches"] = 24, 4
    return manifest.config(BENCH, w["config"]), traffic


def driven(cell: str, seed: int, dev):
    config, traffic = small(cell)
    d = runners.load(traffic["runner"]).Runner(config, traffic, seed, dev)
    for i in range(3):
        d.keep(i, d.call(i))
    return d


@pytest.mark.parametrize("cell", CELLS)
def test_program_equals_reference_on_the_cpu(cell):
    d = driven(cell, 2_718_281_828, torch.device("cpu"))
    numbers = d.numbers()
    if d.phase == "eval":
        assert numbers == {"output_gap": 0.0}
    ok, checks = check.verdict(numbers, check.limits(cell))
    assert ok, checks


def _control_fails(cell: str, dev):
    for seed in (11, 2 ** 31 + 5, 9_000_000_001):
        d = driven(cell, seed, dev)
        ok, checks = check.verdict(d.control_numbers(),
                                   check.limits(cell))
        assert not ok, checks


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    _control_fails(cell, torch.device("cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _control_fails(cell, torch.device("cuda", 0))


def test_noisy_nld_equals_reference_on_the_cpu():
    """NLD under the Fig. 7 noise, which no cell runs yet: the reference
    a later cell would be held to already agrees."""
    config = manifest.config(BENCH, "nmnist-nld")
    traffic = dict(manifest.traffic("eval-mc"), streams=40, test_sets=2)
    d = runners.load("eval").Runner(config, traffic, 77, torch.device("cpu"))
    for i in range(3):
        d.keep(i, d.call(i))
    assert d.numbers() == {"output_gap": 0.0}
