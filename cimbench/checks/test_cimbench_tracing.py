"""The trace's reduction: the port's kernel names, busy time, idle gaps
and per-call counts, on hand-made profiler events."""

import pytest
import torch

from cimbench import manifest, tracing

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class Ev:
    def __init__(self, name, kind, start, dur):
        self._n, self._k, self._s, self._d = name, kind, start, dur

    def name(self):
        return self._n

    def activity_type(self):
        return self._k

    def device_type(self):
        return CPU if self._k in tracing.HOST_OPS else CUDA

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_port_kernels_are_read_from_the_sources():
    names = tracing.port_kernels(manifest.ROOT / "src" / "repro_torch"
                                 / "csrc")
    assert {"kwn_head", "kwn_lif", "fmsn_head", "fmsn_lif", "fmskb_mac",
            "fmskb_chain", "fmskb_dw_part", "fmskb_dw_sum"} <= names
    assert tracing.kernel_name(
        "void kwn_head<4>(KwnHead, CUtensorMap, CUtensorMap, int)") \
        == "kwn_head"
    assert tracing.kernel_name(
        "void at::native::(anonymous namespace)::elementwise_kernel<128, 4>"
        "(int, F)") == "elementwise_kernel"


def test_busy_idle_and_gaps():
    ms = 1_000_000
    events = [
        Ev(tracing.WINDOW, "user_annotation", 0, 100 * ms),
        Ev(tracing.CALL, "user_annotation", 0, 50 * ms),
        Ev(tracing.CALL, "user_annotation", 50 * ms, 50 * ms),
        Ev("aten::add", "cpu_op", 10 * ms, 40 * ms),
        Ev("void kwn_head<4>(P)", "kernel", 5 * ms, 10 * ms),
        Ev("void elementwise_kernel<1>(P)", "kernel", 12 * ms, 8 * ms),
        Ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 60 * ms, 10 * ms),
        Ev(tracing.CALL, "gpu_user_annotation", 0, 100 * ms),
        Ev("void kwn_lif(P)", "kernel", 150 * ms, 10 * ms),   # after
    ]
    tr = tracing.Trace(events)
    assert tr.window_s == pytest.approx(0.1)
    assert tr.calls == 2
    assert tr.busy_s == pytest.approx(0.025)        # 5-20 and 60-70 ms
    assert tr.kernels() == 2
    port = {"kwn_head", "kwn_lif"}
    assert tr.device_s(lambda n: n in port, kernels_only=True) \
        == pytest.approx(0.010)
    assert tr.device_s(lambda n: n not in port) == pytest.approx(0.018)
    gaps = tr.top_idle_gaps(2)
    assert gaps[0] == ["host in aten::add", pytest.approx(0.040)]
    assert gaps[1][1] == pytest.approx(0.030)
    assert tr.top_device_ops(1) == [["kwn_head", pytest.approx(0.010)]]
