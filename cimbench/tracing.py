"""The traced run: the measured window under ``torch.profiler``, reduced
to what the per-layer readers need.

The window and each call in it are marked with ``record_function``
ranges (``cimbench.window``, ``cimbench.call``), so the profiler's own
timeline says where the window lies.  Device operations are the kernels,
copies and fills that ran on the card inside the window; the port's own
kernels are those whose names are a ``__global__`` function of the
port's CUDA sources.
"""

from __future__ import annotations

import re
import time
from pathlib import Path

import numpy as np
import torch

WINDOW = "cimbench.window"
CALL = "cimbench.call"
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_OPS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
# host events of the profiler's own bookkeeping, which name no work
PROFILER_OWN = ("Activity Buffer Request",)
# idle seconds around the window, so that the profiler's window on the
# host's clock holds every device event of the calls
PAD_S = 0.05


def port_kernels(csrc: Path) -> set[str]:
    """The names of the ``__global__`` functions in the port's CUDA
    sources (``.cu`` and ``.cuh``)."""
    names = set()
    bounds = re.compile(r"__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)")
    for path in sorted(csrc.glob("*.cu*")):
        text = bounds.sub(" ", path.read_text())
        names.update(re.findall(r"__global__\s+void\s+(\w+)\s*\(", text))
    return names


def kind(e) -> str:
    """A profiler event's activity type (``kernel``, ``gpu_memcpy``,
    ``gpu_memset``, ``cpu_op``, ``user_annotation``, ...), worked out
    from its device, its name and whether it is an annotation where the
    installed PyTorch's events do not say it themselves."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    cuda = e.device_type() == torch.autograd.DeviceType.CUDA
    annotation = getattr(e, "is_user_annotation", None)
    if (annotation is not None and annotation()) \
            or e.name() in (WINDOW, CALL):
        return "gpu_user_annotation" if cuda else "user_annotation"
    if not cuda:
        return "cpu_op"
    if e.name().startswith("Memcpy"):
        return "gpu_memcpy"
    if e.name().startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def kernel_name(key: str) -> str:
    """A device event's name without its return type, namespaces,
    template arguments and parameters."""
    head = key.replace("(anonymous namespace)::", "").split("(")[0]
    head = head.split("<")[0]
    return re.sub(r"^(void )?(\w+::)*", "", head).strip()


class Trace:
    """The device and host events of one traced window.

    ``window_s``: the window's length; ``busy_s``: the seconds in it in
    which some device operation ran; ``calls``: the calls marked in it;
    ``device``: (name, start_ns, duration_ns, is_kernel) of each device
    operation that started in it; ``gaps``: (start_ns, seconds) of each
    stretch in it with no device operation; ``host``: (name, start_ns,
    end_ns) of each host operation, for naming the gaps.
    """

    def __init__(self, events):
        win = [e for e in events if e.name() == WINDOW
               and kind(e) == "user_annotation"]
        if not win:
            raise RuntimeError("the traced window has no cimbench.window "
                               "range")
        w0 = win[0].start_ns()
        w1 = w0 + win[0].duration_ns()
        self.window_s = (w1 - w0) / 1e9
        self.calls = sum(1 for e in events if e.name() == CALL
                         and kind(e) == "user_annotation")
        self.device, self.host = [], []
        for e in events:
            k, t0 = kind(e), e.start_ns()
            t1 = t0 + e.duration_ns()
            if k in DEVICE_OPS and w0 <= t0 < w1:
                self.device.append((kernel_name(e.name()), t0,
                                    e.duration_ns(), k == "kernel"))
            elif k in HOST_OPS and t1 > w0 and t0 < w1 \
                    and e.name() not in (WINDOW, CALL) + PROFILER_OWN:
                self.host.append((e.name(), t0, t1))
        self.busy_s, self.gaps = self._busy(w0, w1)

    def _busy(self, w0: int, w1: int):
        if not self.device:
            return 0.0, [(w0, (w1 - w0) / 1e9)]
        starts = np.array([d[1] for d in self.device], np.int64)
        ends = np.minimum(starts + np.array([d[2] for d in self.device],
                                            np.int64), w1)
        order = np.argsort(starts)
        starts, ends = starts[order], np.maximum.accumulate(ends[order])
        # a new busy stretch starts where an event starts after every
        # earlier one has ended
        new = np.ones(len(starts), bool)
        new[1:] = starts[1:] > ends[:-1]
        first = np.flatnonzero(new)
        last = np.append(first[1:] - 1, len(starts) - 1)
        s0, s1 = starts[first], ends[last]
        busy = float((s1 - s0).sum()) / 1e9
        edges0 = np.concatenate([[w0], s1])
        edges1 = np.concatenate([s0, [w1]])
        gaps = [(int(a), (int(b) - int(a)) / 1e9)
                for a, b in zip(edges0, edges1) if b > a]
        return busy, gaps

    def device_s(self, which=None, kernels_only: bool = False) -> float:
        """Seconds of the device operations whose name ``which`` accepts
        (all by default)."""
        return sum(d[2] for d in self.device
                   if (which is None or which(d[0]))
                   and (d[3] or not kernels_only)) / 1e9

    def kernels(self) -> int:
        return sum(1 for d in self.device if d[3])

    def top_device_ops(self, n: int = 10) -> list:
        by: dict[str, int] = {}
        for name, _, dur, _ in self.device:
            by[name] = by.get(name, 0) + dur
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def top_idle_gaps(self, n: int = 10) -> list:
        """The longest gaps, each named by the innermost host operation
        running at its middle."""
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:n]
        if not self.host:
            return [["no host operation", s] for _, s in gaps]
        h0 = np.array([h[1] for h in self.host], np.int64)
        h1 = np.array([h[2] for h in self.host], np.int64)
        out = []
        for start, secs in gaps:
            mid = start + int(secs * 5e8)
            inside = np.flatnonzero((h0 <= mid) & (h1 >= mid))
            name = ("no host operation" if not len(inside)
                    else self.host[int(inside[np.argmax(h0[inside])])][0])
            out.append([f"host in {name}", secs])
        return out


def traced(run_window):
    """``run_window(mark)`` under the profiler, where ``mark(name)`` gives
    the ``record_function`` range to put around each call; returns (its
    result, the ``Trace``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PAD_S)
        with record_function(WINDOW):
            result = run_window(lambda: record_function(CALL))
            torch.cuda.synchronize()
        time.sleep(PAD_S)
    return result, Trace(prof.profiler.kineto_results.events())
