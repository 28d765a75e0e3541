"""Observability tooling for the port: validate traces, render metrics,
run the smoke.

The counterpart of ``tools/obs_report.py`` on ``repro_torch.obs``:

  --check TRACE.json      Validate an exported Chrome/Perfetto trace:
                          parses as JSON, ``traceEvents`` is a list,
                          every event carries ``ph``/``ts``/``pid``/
                          ``tid``, complete ("X") events also carry
                          ``name``/``dur``.  Exits nonzero on any
                          violation.
  --metrics M.json        Pretty-print a MetricsRegistry JSON export;
                          ``--prom`` re-renders it as Prometheus text
                          exposition instead.
  --smoke                 Serve a 6-request trace through a tiny traced
                          engine (on the card by default; ``--device
                          cpu`` runs the plain version), export trace +
                          metrics, self-validate the trace, and assert
                          the metric counters equal the engine ledgers
                          and the expected tracks are present.

Usage:
  python tools/obs_report_torch.py --check TRACE.json
  python tools/obs_report_torch.py --metrics METRICS.json [--prom]
  python tools/obs_report_torch.py --smoke [--device cpu] \\
      [--trace-out PATH] [--metrics-out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

REQUIRED_EVENT_KEYS = ("ph", "ts", "pid", "tid")


def check_trace(path: str) -> list[str]:
    """Schema errors in an exported trace file ([] = loadable)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"cannot load {path}: {e}"]
    errs = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return [f"traceEvents: want a list, got {type(events).__name__}"]
    if not events:
        errs.append("traceEvents: empty (nothing was traced?)")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errs.append(f"traceEvents[{i}]: not an object")
            continue
        for key in REQUIRED_EVENT_KEYS:
            if key not in ev:
                errs.append(f"traceEvents[{i}]: missing {key!r}")
        ph = ev.get("ph")
        if ph not in ("X", "M", "i", "I"):
            errs.append(f"traceEvents[{i}]: unknown ph {ph!r}")
        if ph == "X":
            if "name" not in ev:
                errs.append(f"traceEvents[{i}]: X event without name")
            if not isinstance(ev.get("dur"), (int, float)):
                errs.append(f"traceEvents[{i}]: X event without numeric dur")
            if isinstance(ev.get("ts"), (int, float)) and ev["ts"] < 0:
                errs.append(f"traceEvents[{i}]: negative ts {ev['ts']}")
    return errs


def _print_metrics(path: str, prom: bool) -> int:
    with open(path) as f:
        doc = json.load(f)
    series = doc.get("metrics")
    if not isinstance(series, list):
        print(f"{path}: no 'metrics' list")
        return 1
    if prom:
        # replay the JSON export into a fresh registry: one formatter
        from repro_torch.obs import metrics as obs_metrics
        reg = obs_metrics.MetricsRegistry()
        for s in series:
            name, labels = s["name"], s.get("labels", {})
            if s["type"] == "counter":
                reg.counter(name, **labels).inc(s["value"])
            elif s["type"] == "gauge":
                reg.gauge(name, **labels).set(s["value"])
            else:
                h = reg.histogram(name, buckets=s["buckets"], **labels)
                h.counts = list(s["counts"])
                h.overflow = s["overflow"]
                h.total = s["count"]
                h.sum = s["sum"]
                h.min, h.max = s["min"], s["max"]
        print(reg.to_prometheus(), end="")
        return 0
    for s in series:
        lbl = ",".join(f"{k}={v}" for k, v in sorted(s.get(
            "labels", {}).items()))
        name = f"{s['name']}{{{lbl}}}" if lbl else s["name"]
        if s["type"] == "histogram":
            print(f"{name:44s} count={s['count']} sum={s['sum']:.3f} "
                  f"min={s['min']} max={s['max']}")
        else:
            print(f"{name:44s} {s['value']}")
    return 0


def run_smoke(trace_path: str, metrics_path: str, device=None) -> int:
    """6-request engine run with tracing on; validate everything after."""
    import numpy as np
    import torch

    from repro_torch import device as device_lib
    from repro_torch.models import snn as snn_lib
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serve.engine import EventRequest, SNNEventEngine

    dev = device_lib.resolve(device)
    tracer = obs_trace.Tracer(enabled=True)
    prev = obs_trace.set_tracer(tracer)   # snn transfer spans need the global
    try:
        cfg = snn_lib.SNNConfig(n_in=32, n_hidden=16, n_classes=3,
                                n_steps=8, k=4)
        params = snn_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                     device=dev)
        engine = SNNEventEngine(cfg, params, batch_slots=2, round_steps=4,
                                seed=7, tracer=tracer, device=dev)
        rng = np.random.default_rng(0)
        reqs = [EventRequest(
            uid=i, priority=(1 if i == 4 else 0),
            events=(rng.random((int(rng.integers(6, 20)), 32)) < 0.25)
            .astype(np.float32))
            for i in range(6)]
        for r in reqs:
            engine.submit(r)
        engine.run(max_rounds=2)
        # force one preemption mid-serve so the trace shows the full
        # residency story: admit -> rounds -> preempt -> restore -> evict
        resident = next(r for r in engine._slot_req if r is not None)
        engine.preempt_request(resident.uid, backoff=False)
        engine.run()
        n_spans = tracer.export(trace_path)
        with open(metrics_path, "w") as f:
            json.dump(engine.metrics.to_dict(), f, indent=1)
    finally:
        obs_trace.set_tracer(prev)

    failures = []
    errs = check_trace(trace_path)
    if errs:
        failures += [f"trace: {e}" for e in errs]

    # expected tracks: scheduler phases, at least one slot lane, and the
    # checkpoint transfer lane from the forced preemption
    with open(trace_path) as f:
        doc = json.load(f)
    cats = {ev.get("cat") for ev in doc["traceEvents"] if ev.get("ph") == "X"}
    names = {ev.get("name") for ev in doc["traceEvents"]
             if ev.get("ph") == "X"}
    for want in ("scheduler", "slot00", "transfer"):
        if want not in cats:
            failures.append(f"trace: no spans on track {want!r}")
    for want in ("tick", "round", "admit", "evict", "checkpoint_save",
                 "checkpoint_restore"):
        if want not in names:
            failures.append(f"trace: no {want!r} span recorded")

    # counter / ledger consistency (the same invariant chaos asserts)
    m = engine.metrics
    checks = [
        ("terminal_total{state=completed}",
         m.value("terminal_total", state="completed"),
         len(engine.completed)),
        ("terminal_total{state=rejected}",
         m.value("terminal_total", state="rejected"), len(engine.rejected)),
        ("terminal_total{state=expired}",
         m.value("terminal_total", state="expired"), len(engine.expired)),
        ("preempted_total", m.value("preempted_total"),
         engine.preemption_count),
        ("completed requests", len(engine.completed), len(reqs)),
    ]
    for what, got, want in checks:
        if got != want:
            failures.append(f"metrics: {what} = {got}, want {want}")
    if m.histogram("round_ms").total == 0:
        failures.append("metrics: round_ms histogram is empty")

    if failures:
        print("[obs-smoke] FAIL")
        for msg in failures:
            print(f"  {msg}")
        return 1
    print(f"[obs-smoke] ok on {dev}: {n_spans} spans -> {trace_path}, "
          f"{len(m.series())} metric series -> {metrics_path}, "
          f"counters == ledgers")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--check", metavar="TRACE.json",
                    help="validate an exported Perfetto trace file")
    ap.add_argument("--metrics", metavar="METRICS.json",
                    help="render a metrics JSON export")
    ap.add_argument("--prom", action="store_true",
                    help="with --metrics: Prometheus text format")
    ap.add_argument("--smoke", action="store_true",
                    help="run the traced 6-request engine smoke")
    ap.add_argument("--device", default=None,
                    help="smoke device: cuda (default) or cpu")
    tmp = tempfile.gettempdir()
    ap.add_argument("--trace-out",
                    default=os.path.join(tmp, "obs_smoke_torch_trace.json"),
                    help="smoke trace output path")
    ap.add_argument("--metrics-out",
                    default=os.path.join(tmp, "obs_smoke_torch_metrics.json"),
                    help="smoke metrics output path")
    args = ap.parse_args(argv)

    if args.smoke:
        return run_smoke(args.trace_out, args.metrics_out, args.device)
    if args.check:
        errs = check_trace(args.check)
        if errs:
            print(f"{args.check}: INVALID")
            for e in errs:
                print(f"  {e}")
            return 1
        with open(args.check) as f:
            n = sum(1 for ev in json.load(f)["traceEvents"]
                    if ev.get("ph") == "X")
        print(f"{args.check}: ok ({n} spans)")
        return 0
    if args.metrics:
        return _print_metrics(args.metrics, args.prom)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
