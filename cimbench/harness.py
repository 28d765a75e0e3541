"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line.

    python3 cimbench/run.py --workload NAME --seed N --seconds S --trace 0|1

With ``--trace 0`` the result's metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer ones, from the same window run
under ``torch.profiler``.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and ``checks`` last: each number
compared beside its limit); the numbers compared are also the last lines
of standard error.  Without enough CUDA devices, or with JAX or the JAX
package loaded once the window has closed, the run prints no result and
exits with a code other than 0.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from cimbench import check, counts, manifest, runners, stats, tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="cimbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, whole)
    is JAX's, jaxlib's, flax's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def run_window(runner, seconds: float, dev, mark=None) -> stats.Window:
    """Calls until ``seconds`` have passed since the first one started;
    each call ends in a synchronise before the next starts."""
    window = stats.Window(runner.units)
    i = 0
    while True:
        t0 = time.perf_counter()
        if mark is None:
            out = runner.call(i)
            t1 = time.perf_counter()
        else:
            with mark():
                out = runner.call(i)
                t1 = time.perf_counter()
        runners.sync(dev)
        t2 = time.perf_counter()
        window.add(t0, t1, t2)
        runner.keep(i, out)
        i += 1
        if t2 - window.starts[0] >= seconds:
            return window


class Context:
    """What a metric's reader may read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = manifest.load()
    cell = manifest.workload(bench, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"cimbench: {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = execute(bench, cell, manifest.traffic(cell["traffic"]),
                     args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"cimbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


def execute(bench: dict, cell: dict, traffic: dict, seed: int,
            seconds: float, traced: bool, dev, t_start: float) -> dict:
    """Set-up, the window, the comparison and the metrics of one run of
    ``cell`` on ``dev``; returns the result object."""
    config = manifest.config(bench, cell["config"])
    limit = check.limits(cell["name"])
    cuda = dev.type == "cuda"
    runner = runners.load(traffic["runner"]).Runner(config, traffic, seed,
                                                    dev)
    runners.sync(dev)
    setup_s = time.perf_counter() - t_start
    trace = None
    if traced:
        window, trace = tracing.traced(
            lambda mark: run_window(runner, seconds, dev, mark))
    else:
        window = run_window(runner, seconds, dev)
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.empty_cache()
    numbers = runner.numbers()
    correct, checks = check.verdict(numbers, limit)
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    ctx = Context(cell=cell, config=config, traffic=traffic,
                  phase=runner.phase, setup_s=setup_s, window=window,
                  trace=trace, telemetry=runner.telemetry(),
                  work=runner.work(),
                  peak=counts.peaks(kind), port=tracing.port_kernels(
                      manifest.ROOT / "src" / "repro_torch" / "csrc"))
    metrics = {}
    for m in manifest.metrics(bench, cell["name"], traced):
        value = manifest.reader(m["name"])(ctx)
        if value is None or not math.isfinite(value):
            print(f"cimbench: {m['name']} found nothing to read",
                  file=sys.stderr)
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind,
              "count": cell["chips"], "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": window.calls,
              "failed": 0 if correct else 1, "metrics": metrics,
              "device": device}
    if trace is not None:
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.top_device_ops(),
                               "idle_gaps": trace.top_idle_gaps()}
    result["checks"] = checks
    return result
