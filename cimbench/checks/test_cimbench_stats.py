"""The window's arithmetic: exact percentiles and rates over every call,
a stall included."""

import statistics

import pytest

from cimbench import stats


def test_percentile_is_exact_over_all_samples():
    xs = [float(v) for v in range(1, 101)]
    assert stats.percentile(xs, 0.0) == 1.0
    assert stats.percentile(xs, 1.0) == 100.0
    assert stats.percentile(xs, 0.95) == pytest.approx(95.05)
    assert stats.median([3.0, 1.0, 2.0]) == 2.0
    assert stats.median(xs) == statistics.median(xs)


def test_rate_and_tail_count_a_stall():
    w = stats.Window(units_per_call=1000)
    for start, end in ((0.0, 1.0), (1.0, 2.0), (2.0, 3.0), (9.0, 10.0)):
        w.add(start, start + 0.25, end)
    # the idle 6 s between the third call and the fourth count
    assert w.seconds == 10.0
    assert w.units_per_s() == pytest.approx(400.0)
    assert w.call_ms() == [1000.0] * 4
    assert w.host_ms() == [250.0] * 4
    w.add(10.0, 10.1, 17.0)           # a call that stalls itself
    assert stats.percentile(w.call_ms(), 0.95) == pytest.approx(5800.0)
    assert w.units_per_s() == pytest.approx(5000 / 17.0)


def test_percentile_of_nothing_raises():
    with pytest.raises(ValueError):
        stats.percentile([], 0.5)
