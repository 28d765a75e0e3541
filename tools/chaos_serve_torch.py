"""Chaos harness for the port's preemptive SNNEventEngine: adversarial
traffic with hard assertions.

The five scenarios of ``tools/chaos_serve.py`` on ``repro_torch``'s
engine and ``serve/lifecycle.py``, with the same assertions (the serving
invariants of docs/SERVING.md):

  burst_shed       oversized burst into a bounded queue -> typed REJECTED
                   outcomes, every submission reaches a terminal state,
                   accepted requests still serve with bitwise parity.
  malformed        NaN / non-ternary / wrong-shape / empty tensors -> the
                   typed lifecycle errors, and the engine keeps serving
                   clean traffic afterwards (no poisoned slot state).
  random_preempt   forced preemptions at randomized step offsets
                   (including non-multiples of round_steps), clean and
                   noisy -> results bitwise-identical to uninterrupted
                   one-shot runs, returned in submission order.
  hog_shorts       hog streams + prioritized shorts -> with preemption the
                   shorts' p95 latency is no worse than without it
                   (fairness SLO), and the hogs still finish exactly.
  deadline_storm   a storm of impossible + feasible deadlines -> expired
                   requests get the typed EXPIRED outcome, feasible ones
                   complete, nothing is silently dropped.

Every scenario also holds the engine's metric counters equal to its
ledgers.  Any violated assertion exits nonzero.  Runs on the card by
default (the seq-KWN kernel serves every round); ``--device cpu`` runs
the plain version.

Usage:
  python tools/chaos_serve_torch.py --smoke
  PYTHONPATH=src python tools/chaos_serve_torch.py --smoke --device cpu
  python tools/chaos_serve_torch.py --seed 7 --scenario random_preempt
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import zlib

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import device as device_lib  # noqa: E402
from repro_torch.core import ima as ima_lib  # noqa: E402
from repro_torch.models import snn as snn_lib  # noqa: E402
from repro_torch.serve import lifecycle  # noqa: E402
from repro_torch.serve.engine import EventRequest, SNNEventEngine  # noqa: E402

DEV = None      # the device every scenario runs on (set by main)


def _setup():
    cfg = snn_lib.SNNConfig(n_in=32, n_hidden=16, n_classes=3, n_steps=8,
                            k=4)
    params = snn_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                 device=DEV)
    return cfg, params


def _engine(cfg, params, **kw) -> SNNEventEngine:
    return SNNEventEngine(cfg, params, device=DEV, **kw)


def _events(rng, t, n_in=32, rate=0.25):
    return (rng.random((t, n_in)) < rate).astype(np.float32)


def _one_shot(params, cfg, req, noise=None):
    logits, tele = snn_lib.forward_silicon(
        params, np.asarray(req.events)[None], cfg,
        seed=req.seed if noise is not None else 0, noise=noise,
        fused="seq", device=DEV)
    return logits[0].cpu(), float(tele["adc_steps"][0])


def _check_parity(params, cfg, reqs, noise=None):
    for r in reqs:
        assert r.state == lifecycle.COMPLETED, \
            f"uid {r.uid}: state {r.state!r}, want completed"
        ref_logits, ref_adc = _one_shot(params, cfg, r, noise=noise)
        assert torch.equal(torch.as_tensor(r.logits).cpu(), ref_logits), \
            f"uid {r.uid}: served logits != one-shot (bitwise)"
        assert r.adc_steps == ref_adc, \
            f"uid {r.uid}: adc_steps {r.adc_steps} != one-shot {ref_adc}"


def _terminal_ledger(engine, submitted):
    """Every submission must sit in exactly one terminal ledger."""
    fates = {id(r): r.state for r in
             engine.completed + engine.rejected + engine.expired}
    for r in submitted:
        st = fates.get(id(r))
        assert st in lifecycle.TERMINAL_STATES, \
            f"uid {r.uid}: no terminal state (got {st!r})"
    total = (len(engine.completed) + len(engine.rejected) +
             len(engine.expired))
    assert total == len(submitted), \
        f"ledger holds {total} requests, submitted {len(submitted)}"
    _metrics_match_ledgers(engine)


def _metrics_match_ledgers(engine):
    """The engine's metric counters must agree with its ledgers exactly."""
    m = engine.metrics
    for state, ledger in (("completed", engine.completed),
                          ("rejected", engine.rejected),
                          ("expired", engine.expired)):
        got = m.value("terminal_total", state=state)
        assert got == len(ledger), \
            f"terminal_total{{state={state}}} = {got}, " \
            f"ledger holds {len(ledger)}"
    assert m.value("shed_total") == len(engine.rejected), \
        f"shed_total {m.value('shed_total')} != {len(engine.rejected)}"
    assert m.value("expired_total") == len(engine.expired), \
        f"expired_total {m.value('expired_total')} != {len(engine.expired)}"
    assert m.value("preempted_total") == engine.preemption_count, \
        f"preempted_total {m.value('preempted_total')} != " \
        f"{engine.preemption_count}"


# --- scenarios -------------------------------------------------------------

def scenario_burst_shed(rng, smoke):
    cfg, params = _setup()
    n = 12 if smoke else 48
    cap = 4
    engine = _engine(cfg, params, batch_slots=2, round_steps=4,
                     max_pending=cap, seed=3)
    reqs = [EventRequest(uid=i, priority=int(rng.integers(0, 3)),
                         events=_events(rng, int(rng.integers(4, 16))))
            for i in range(n)]
    for r in reqs:
        engine.submit(r)          # one giant burst, no draining between
    assert len(engine.pending) <= cap, "bounded queue overflowed"
    assert engine.rejected, "oversized burst shed nothing"
    engine.run()
    _terminal_ledger(engine, reqs)
    _check_parity(params, cfg, [r for r in reqs if r in engine.completed])
    return f"{len(engine.rejected)} shed, {len(engine.completed)} served"


def scenario_malformed(rng, smoke):
    cfg, params = _setup()
    engine = _engine(cfg, params, batch_slots=2, round_steps=4)
    nan_ev = np.zeros((6, 32), np.float32)
    nan_ev[3, 7] = np.nan
    hostile = [
        (np.zeros((0, 32), np.float32), lifecycle.EmptyEventError),
        (np.zeros((4, 31), np.float32), lifecycle.EventShapeError),
        (np.zeros((4,), np.float32), lifecycle.EventShapeError),
        (nan_ev, lifecycle.NonFiniteEventError),
        (np.full((4, 32), 0.5, np.float32), lifecycle.NonTernaryEventError),
        (np.array([["x"] * 32] * 4), lifecycle.EventDtypeError),
    ]
    for i, (ev, want) in enumerate(hostile):
        try:
            engine.submit(EventRequest(uid=100 + i, events=ev))
        except want:
            pass
        else:
            raise AssertionError(
                f"hostile tensor #{i} not rejected with {want.__name__}")
    # the engine must still serve clean traffic exactly afterwards
    clean = [EventRequest(uid=i, events=_events(rng, 8)) for i in range(4)]
    for r in clean:
        engine.submit(r)
    engine.run()
    _check_parity(params, cfg, clean)
    _metrics_match_ledgers(engine)
    return f"{len(hostile)} hostile tensors rejected, engine healthy"


def scenario_random_preempt(rng, smoke):
    cfg, params = _setup()
    cases = 2 if smoke else 6
    summary = []
    for case in range(cases):
        noise = None if case % 2 == 0 else ima_lib.IMANoiseModel()
        n = 5 if smoke else 8
        engine = _engine(cfg, params, batch_slots=3, round_steps=4,
                         seed=int(rng.integers(0, 99)), noise=noise)
        reqs = [EventRequest(uid=i,
                             events=_events(rng, int(rng.integers(5, 24))))
                for i in range(n)]
        for r in reqs:
            engine.submit(r)
        budget = [3]

        def hook(eng):
            if not budget[0] or rng.random() < 0.4:
                return
            live = [(i, r) for i, r in enumerate(eng._slot_req)
                    if r is not None]
            if not live:
                return
            slot, victim = live[int(rng.integers(0, len(live)))]
            done = int(eng._slot_done[slot])
            length = int(eng._slot_len[slot])
            if done >= length - 1:
                return
            at = int(rng.integers(done + 1, length))  # any offset
            eng.preempt_request(victim.uid, at_step=at, backoff=False)
            budget[0] -= 1

        done = engine.run(round_hook=hook)
        assert [r.uid for r in done] == [r.uid for r in reqs], \
            "results not in submission order"
        _check_parity(params, cfg, reqs, noise=noise)
        _metrics_match_ledgers(engine)
        summary.append(engine.preemption_count)
    return f"preemptions per case: {summary}, all bitwise-exact"


def _hog_shorts_trace(seed, smoke):
    hog_t, short_t = (48, 6) if smoke else (96, 8)
    n_hogs, n_shorts = (2, 6) if smoke else (2, 12)
    rng = np.random.default_rng(seed)
    hogs = [_events(rng, hog_t) for _ in range(n_hogs)]
    shorts = [_events(rng, short_t) for _ in range(n_shorts)]
    return hogs, shorts


def _run_hog_shorts(params, cfg, hogs, shorts, preemptive):
    engine = _engine(cfg, params, batch_slots=2, round_steps=4,
                     preemptive=preemptive, preempt_quantum=1,
                     backoff_rounds=1, seed=5)
    hog_reqs = [EventRequest(uid=i, priority=0, events=ev)
                for i, ev in enumerate(hogs)]
    for r in hog_reqs:
        engine.submit(r)
    engine.run(max_rounds=1)      # hogs take residence first
    short_reqs = [EventRequest(uid=100 + i, priority=1, events=ev)
                  for i, ev in enumerate(shorts)]
    for r in short_reqs:
        engine.submit(r)
    engine.run()
    lat = sorted(r.latency_ms for r in short_reqs)
    p95 = lat[min(len(lat) - 1, int(len(lat) * 0.95))]
    return engine, hog_reqs, short_reqs, p95


def scenario_hog_shorts(rng, smoke):
    cfg, params = _setup()
    seed = int(rng.integers(0, 2 ** 31))
    hogs, shorts = _hog_shorts_trace(seed, smoke)
    # a warm-up run first (the card's lazy kernel build and first
    # launches): the comparison below then measures scheduling
    _run_hog_shorts(params, cfg, hogs, shorts, preemptive=True)
    eng_on, hogs_on, shorts_on, p95_on = _run_hog_shorts(
        params, cfg, hogs, shorts, preemptive=True)
    eng_off, hogs_off, shorts_off, p95_off = _run_hog_shorts(
        params, cfg, hogs, shorts, preemptive=False)
    assert eng_on.preemption_count >= 1, "hog trace triggered no preemption"
    assert eng_off.preemption_count == 0
    _check_parity(params, cfg, hogs_on + shorts_on)
    _metrics_match_ledgers(eng_on)
    _metrics_match_ledgers(eng_off)
    # fairness SLO: preemption must not make the shorts *worse* (a 1.5x
    # guard band against timing jitter; the structural gap in this trace
    # is the other way)
    assert p95_on <= p95_off * 1.5, \
        f"shorts p95 with preemption {p95_on:.1f}ms worse than " \
        f"without {p95_off:.1f}ms"
    return (f"shorts p95: {p95_on:.1f}ms preemptive vs {p95_off:.1f}ms "
            f"FIFO ({eng_on.preemption_count} preemptions)")


def scenario_deadline_storm(rng, smoke):
    cfg, params = _setup()
    n = 8 if smoke else 24
    engine = _engine(cfg, params, batch_slots=2, round_steps=4, seed=11)
    reqs = []
    for i in range(n):
        impossible = i % 3 == 0
        reqs.append(EventRequest(
            uid=i, deadline_ms=0.0 if impossible else 60_000.0,
            events=_events(rng, int(rng.integers(4, 12)))))
    for r in reqs:
        engine.submit(r)
    engine.run()
    _terminal_ledger(engine, reqs)
    want_expired = [r for r in reqs if r.deadline_ms == 0.0]
    for r in want_expired:
        assert r.state == lifecycle.EXPIRED, \
            f"uid {r.uid}: impossible deadline not expired ({r.state})"
    served = [r for r in reqs if r.deadline_ms > 0.0]
    _check_parity(params, cfg, served)
    assert all(r.deadline_missed is False for r in served)
    return f"{len(want_expired)} expired (typed), {len(served)} on time"


SCENARIOS = {
    "burst_shed": scenario_burst_shed,
    "malformed": scenario_malformed,
    "random_preempt": scenario_random_preempt,
    "hog_shorts": scenario_hog_shorts,
    "deadline_storm": scenario_deadline_storm,
}


def main(argv=None) -> int:
    global DEV
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0,
                    help="trace RNG seed (traces are seeded + replayable)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced trace sizes")
    ap.add_argument("--scenario", choices=sorted(SCENARIOS), default=None,
                    help="run one scenario instead of all")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export a Perfetto trace of the whole chaos run")
    args = ap.parse_args(argv)
    DEV = device_lib.resolve(args.device)

    if args.trace_out:
        from repro_torch.obs import trace as obs_trace
        obs_trace.set_tracer(obs_trace.Tracer(enabled=True))

    names = [args.scenario] if args.scenario else list(SCENARIOS)
    failures = 0
    for name in names:
        # zlib.crc32, not hash(): str hashing is salted per process
        rng = np.random.default_rng(
            args.seed * 1000 + zlib.crc32(name.encode()) % 997)
        t0 = time.perf_counter()
        try:
            detail = SCENARIOS[name](rng, args.smoke)
            status = "ok"
        except AssertionError as e:
            detail, status, failures = str(e), "FAIL", failures + 1
        dt = time.perf_counter() - t0
        print(f"[chaos] {name:16s} {status:4s} ({dt:5.1f}s)  {detail}")
    if args.trace_out:
        from repro_torch.obs import trace as obs_trace
        n = obs_trace.get_tracer().export(args.trace_out)
        print(f"[chaos] wrote {n} spans to {args.trace_out}")
    if failures:
        print(f"[chaos] {failures} scenario(s) violated serving invariants")
        return 1
    print(f"[chaos] all {len(names)} scenarios hold on {DEV} "
          f"(seed {args.seed})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
