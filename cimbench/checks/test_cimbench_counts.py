"""The shape-only counts behind ``mfu`` and the macro's roofline."""

import pytest

from cimbench import counts, manifest

BENCH = manifest.load()


def work(cell):
    w = manifest.workload(BENCH, cell)
    traffic = manifest.traffic(w["traffic"])
    train = traffic["runner"] == "train"
    return counts.macro_work(manifest.config(BENCH, w["config"])["snn"],
                             traffic["batch" if train else "streams"],
                             traffic["noise"] is not None, train)


def test_clean_kwn_pass():
    t, b, k, n = 20, 10000, 512, 128
    w = work("nmnist-kwn.eval")
    assert w["int8_ops"] == 2 * t * b * k * n == 26_214_400_000
    assert w["f32_flops"] == 0
    read = t * b * k + 2 * k * n + 63 * 4 + n * 4 + b * n * 4 + t * b * n * 4
    written = t * b * n * 4 + t * b * 4 + b * n * 4
    assert w["bytes"] == read + written == 318_371_836


def test_noisy_pass_reads_no_kicks():
    clean, noisy = work("nmnist-kwn.eval"), work("nmnist-kwn.eval-mc")
    assert clean["bytes"] - noisy["bytes"] == 20 * 10000 * 128 * 4
    assert clean["int8_ops"] == noisy["int8_ops"]


def test_nld_pass_counts_every_branch_column():
    w = work("nmnist-nld.eval")
    assert w["int8_ops"] == 2 * 20 * 10000 * 512 * 256


def test_training_step():
    t, b, k, n = 20, 8192, 512, 128
    w = work("nmnist-kwn.finetune")
    assert w["int8_ops"] == 2 * t * b * k * n
    assert w["f32_flops"] == 2 * t * b * k * n


def test_ideal_seconds_on_the_h100():
    peak = counts.peaks("NVIDIA H100 80GB HBM3")
    ops_s, bytes_s = counts.ideal_seconds(work("nmnist-kwn.eval"), peak)
    assert ops_s == pytest.approx(26_214_400_000 / 1.979e15)
    assert bytes_s == pytest.approx(318_371_836 / 3.35e12)
    assert counts.peaks("some other card") is None
