"""Serving: the batched event-stream engine on the fused macro kernel, and
the LM's decode step and continuous-batching engine.

Counterpart of ``repro.serve.engine``.  ``SNNEventEngine``'s continuous
path keeps ``batch_slots`` persistent slots whose LIF membranes live on
the device and advances them ``round_steps`` steps per kernel launch; the
legacy path drains the queue in whole-sequence batches.
``build_serve_step`` is one decode token for a batch of requests, and
``BatchedEngine`` admits LM requests into fixed slots, prefills them token
by token through that step and decodes until each completes.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import ctrprng, f32math
from repro_torch.core import energy as energy_lib
from repro_torch.models import lm
from repro_torch.models import snn as snn_lib
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import lifecycle

# Round-time estimation (see _round_ms_estimate): an EMA for the first
# rounds, then the exact p95 of the recent-sample window (admission slack
# needs the tail, not the center).
ROUND_MS_EMA_DECAY = 0.9          # weight on history per EMA update
ROUND_MS_P95_MIN_SAMPLES = 8      # exact-p95 takes over at this depth
ROUND_MS_SAMPLE_WINDOW = 512      # recent rounds kept for exact quantiles

# Fixed bucket edges for the per-request metric histograms.
ADC_STEP_BUCKETS = (1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0, 12.0,
                    14.0, 15.0)
RATIO_BUCKETS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)
PJ_PER_SOP_BUCKETS = (0.25, 0.5, 0.75, 1.0, 1.25, 1.5, 2.0, 3.0, 5.0)

# Key-lane tags of the derived seed words (request seeds, legacy batches).
_TAG_REQUEST = 0x52455131
_TAG_BATCH = 0x42415431


def _derived_seed(engine_seed: int, tag: int, index: int) -> int:
    """A non-negative int32 seed word: Threefry of (engine seed, tag) at
    counter (index, 0)."""
    word, _ = ctrprng.threefry2x32(engine_seed, tag, index, 0)
    return int(word) & 0x7FFFFFFF


def build_serve_step(cfg: lm.LMConfig, *, temperature: float = 0.0):
    """Returns step(params, cache, tokens, pos, generator) ->
    (next tokens (B, 1) int32, logits (B, V), cache).

    Greedy at ``temperature == 0``; above it the next token is drawn from
    ``softmax(logits / temperature)`` with ``generator`` (its draws are
    not ``jax.random``'s)."""

    def serve_step(params, cache, tokens, pos, generator):
        logits, cache = lm.decode_step(params, cache, tokens, pos, cfg)
        logits = logits[:, :cfg.vocab_size]
        if temperature > 0.0:
            probs = torch.softmax(logits / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt[:, None].to(torch.int32), logits, cache

    return serve_step


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    generated: list[int] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


@dataclasses.dataclass
class EventRequest:
    """One event-stream classification request: events (T, N_in) in {-1,0,1}.

    ``priority`` (higher wins) and ``deadline_ms`` (wall milliseconds from
    submission) feed the preemptive scheduler; both default to "no
    opinion", under which the engine behaves exactly like the plain
    continuous-batching engine (no preemption ever triggers).  ``state``
    walks the ``serve.lifecycle`` machine and always ends in a terminal
    state — COMPLETED, EXPIRED, or REJECTED.
    """

    uid: int
    events: Any                 # (T, N_in) array-like
    label: int | None = None
    logits: Any = None
    pred: int | None = None
    adc_steps: float | None = None   # mean early-stop ramp steps per time step
    density: float | None = None     # measured |event| rate (set on submit)
    skipped_block_ratio: float | None = None  # batch activity-plan skip rate
    seed: int | None = None          # counter-PRNG seed word (None: derived)
    latency_ms: float | None = None  # submit -> eviction wall time
    sops: float | None = None        # measured synaptic ops per time step
    priority: int = 0                # scheduler priority (higher preempts)
    deadline_ms: float | None = None  # SLO deadline, wall ms from submit
    state: str = lifecycle.QUEUED    # lifecycle state (see serve.lifecycle)
    preemptions: int = 0             # times this request was checkpointed out
    preempted_ms: float = 0.0        # total wall ms spent checkpointed out
    deadline_missed: bool | None = None  # completed after its deadline?
    _order: int | None = dataclasses.field(default=None, repr=False,
                                           compare=False)  # submission index
    _t_submit: float | None = dataclasses.field(default=None, repr=False,
                                                compare=False)
    _ckpt: Any = dataclasses.field(default=None, repr=False, compare=False)
    _not_before: int = dataclasses.field(default=0, repr=False, compare=False)
    _t_preempt_out: float | None = dataclasses.field(default=None, repr=False,
                                                     compare=False)
    _span: Any = dataclasses.field(default=None, repr=False, compare=False)


class SNNEventEngine:
    """Event-stream inference on the fused macro kernel, served either by
    step-granularity *continuous batching* (default) or by legacy
    drain-the-queue batches.

    **Continuous path** (``continuous=True``, the default for single-layer
    configs, KWN or NLD).  The engine keeps ``batch_slots``
    persistent serving slots whose LIF membrane — the SNN analog of an LM
    engine's KV cache — lives on device in a
    ``snn.SiliconStreamState`` and is carried across rounds.  Each round
    advances every occupied slot by ``round_steps`` time steps through
    one time-major fused kernel launch; between rounds, finished requests
    are evicted (their slot's accumulators are normalized by *their own*
    stream length, never the round count) and waiting requests are
    admitted into the freed slots mid-flight, with the slot state reset
    on admit.  Mixed stream lengths batch naturally — the batch shape is
    always ``(round_steps, batch_slots)`` whatever the traffic's length
    mix.

    Noise is *per-request* on this path: each request's counter-PRNG seed
    (``req.seed``, else derived from the engine seed and the submission
    index through ``core.ctrprng``) rides the kernel's ``row_ctl`` lane, and the clean-path SNL PRBS is a
    per-slot LFSR.  Served logits and ADC telemetry are therefore
    bitwise-identical to a one-shot batch-1
    ``forward_silicon(fused="seq")`` of the same request — independent of
    co-batched traffic, admission order, or scheduling policy.

    With ``pack_by_density=True`` the admission scheduler uses measured
    event density as its cost model: it fills free slots with the pending
    requests closest to the resident batch's mean density (quietest-first
    into an empty batch), so activity-gated block skipping — which is
    per row-*tile*, shared across co-resident slots — survives batching.
    Results are unchanged either way; only the work moves.

    **Legacy path** (``continuous=False``).  One
    ``forward_silicon(fused="seq")`` call per fixed-size batch of whole
    sequences, padded to ``batch_slots`` rows; batches are bucketed by
    stream length.  ``noise`` draws then come from a per-batch seed word
    derived from the engine seed.  Layer stacks are served only here
    (the default for them; ``continuous=True`` raises ``ValueError``).

    Everything runs on ``device`` (default ``cuda``).  Counterpart of
    ``repro.serve.engine.SNNEventEngine``.

    **Robustness layer** (what turns the round loop into something that
    can face real traffic):

    * *Validation*: ``submit()`` rejects malformed event tensors with the
      typed ``serve.lifecycle`` errors before anything is staged for a
      kernel launch (``validate=False`` opts out for trusted callers).
    * *Load shedding*: with ``max_pending`` set, the admission queue is
      bounded — an overflowing submit sheds the lowest-priority (then
      newest) queued request with the terminal ``REJECTED`` state instead
      of growing without bound.
    * *Deadlines*: a queued request whose ``deadline_ms`` passes before it
      can be admitted is retired with the terminal ``EXPIRED`` state
      (resident requests always run to completion — finishing beats
      killing mid-stream).
    * *Preemption* (continuous path, ``preemptive=True``): when the queue
      holds a higher-priority or deadline-at-risk request and no slot is
      free, the scheduler checkpoints the longest-running lowest-priority
      slot to host memory (``snn.SlotCheckpoint``) and admits the urgent
      request.  The victim re-enters the queue with exponential backoff
      (``backoff_rounds * 2**(preemptions-1)`` scheduling ticks) and
      resumes from its checkpoint — in any free slot, at its exact step
      offset — bitwise-identical to an uninterrupted run.  Thrash guards:
      a slot must be resident ``preempt_quantum`` rounds before it is a
      victim, a request is never preempted more than ``max_preemptions``
      times, and at most one preemption happens per scheduling tick.

    Raw-MAC telemetry stays off on both hot paths.
    """

    def __init__(self, cfg: snn_lib.SNNConfig, params, batch_slots: int = 64,
                 seed: int = 0, noise=None,
                 pack_by_density: bool = True,
                 continuous: bool | None = None, round_steps: int = 8,
                 max_pending: int | None = None, preemptive: bool = True,
                 preempt_quantum: int = 1, max_preemptions: int = 3,
                 backoff_rounds: int = 1, risk_margin_ms: float | None = None,
                 validate: bool = True, tracer=None, metrics=None,
                 device=None):
        self.cfg = cfg
        self.device = device_lib.resolve(device)
        self.params = snn_lib.params_to(params, self.device)
        single = len(cfg.layer_widths) == 1
        if continuous is None:
            continuous = single
        elif continuous and not single:
            raise ValueError(
                "continuous batching needs a single-layer config; pass "
                "continuous=False (or leave it None to auto-select) for "
                "stacks")
        # packed once for the continuous path; the drain path packs per call
        self._fw = snn_lib.pack_fused(self.params, cfg, noise) \
            if single else None
        self.b = batch_slots
        self.noise = noise
        self.pack_by_density = pack_by_density
        self.pending: list[EventRequest] = []
        self.completed: list[EventRequest] = []
        self.rejected: list[EventRequest] = []
        self.expired: list[EventRequest] = []
        self._submitted = 0
        self._seed = seed
        self._batches = 0                # legacy-path batch counter
        self.continuous = continuous
        self.round_steps = round_steps
        self.max_pending = max_pending
        self.preemptive = preemptive
        self.preempt_quantum = preempt_quantum
        self.max_preemptions = max_preemptions
        self.backoff_rounds = backoff_rounds
        # deadline-risk margin: a deadline-bearing candidate counts as
        # at-risk when its estimated slack falls under this many wall ms.
        # None = auto (two rounds at the measured EMA round time).
        self.risk_margin_ms = risk_margin_ms
        self.validate = validate
        self.preemption_count = 0        # total preemptions (policy + forced)
        self._rounds_total = 0           # monotonic scheduling-tick counter
        self._round_ms = 0.0             # EMA wall ms per round (estimates)
        self._round_samples: deque[float] = deque(
            maxlen=ROUND_MS_SAMPLE_WINDOW)
        # observability: spans go to the engine tracer (falls back to the
        # process-global, which starts disabled — the zero-cost default);
        # metrics are always recorded into a per-engine registry so the
        # chaos harness can cross-check counters against *this* engine's
        # ledgers without bleed from other engines in the process.
        self._tracer = tracer
        self.metrics = metrics if metrics is not None \
            else obs_metrics.MetricsRegistry()
        m = self.metrics
        self._m_rounds = m.counter("rounds_total")
        self._m_round_ms = m.histogram("round_ms")
        self._m_admitted = m.counter("admitted_total")
        self._m_evicted = m.counter("evicted_total")
        self._m_preempted = m.counter("preempted_total")
        self._m_shed = m.counter("shed_total")
        self._m_expired = m.counter("expired_total")
        self._m_queue = m.gauge("queue_depth")
        self._m_occupancy = m.gauge("slot_occupancy")
        self._m_terminal = {
            s: m.counter("terminal_total", state=s)
            for s in sorted(lifecycle.TERMINAL_STATES)}
        self._m_latency = m.histogram("request_latency_ms")
        self._m_adc = m.histogram("request_adc_steps",
                                  buckets=ADC_STEP_BUCKETS)
        self._m_skip = m.histogram("request_skipped_block_ratio",
                                   buckets=RATIO_BUCKETS)
        self._m_pj = m.histogram("request_pj_per_sop",
                                 buckets=PJ_PER_SOP_BUCKETS)
        # continuous-path slot table (host shadows of the device state)
        self._state = (snn_lib.silicon_stream_init(cfg, batch_slots,
                                                   device=self.device)
                       if self.continuous else None)
        self._slot_req: list[EventRequest | None] = [None] * batch_slots
        self._slot_len = np.zeros(batch_slots, np.int32)
        self._slot_done = np.zeros(batch_slots, np.int32)
        self._slot_seed = np.zeros(batch_slots, np.int32)
        self._slot_admit_round = np.zeros(batch_slots, np.int64)

    @property
    def tracer(self) -> obs_trace.Tracer:
        """Engine tracer: the one passed at construction, else the
        process-global (resolved per access so ``set_tracer`` after
        engine construction still takes effect)."""
        t = self._tracer
        return t if t is not None else obs_trace.get_tracer()

    def _record_terminal(self, req: EventRequest) -> None:
        """Exactly-one-increment bookkeeping for a terminal transition.

        Every code path that appends to a terminal ledger (completed /
        rejected / expired) calls this exactly once, so
        ``terminal_total{state=...}`` always equals the ledger lengths —
        the invariant the serving tests assert.
        """
        self._m_terminal[req.state].inc()

    def _observe_completed(self, req: EventRequest) -> None:
        """Feed the per-request telemetry histograms at completion."""
        if req.latency_ms is not None:
            self._m_latency.observe(req.latency_ms)
        if req.adc_steps is not None:
            self._m_adc.observe(req.adc_steps)
        if req.skipped_block_ratio is not None:
            self._m_skip.observe(req.skipped_block_ratio)
        if req.adc_steps is not None and self.cfg.mode == "kwn" \
                and req.density:
            # modeled pJ/SOP for *this* request: the calibrated component
            # model evaluated at the request's measured early-stop depth,
            # with its measured event density standing in for the
            # dataset spike rate (the engine does not know the dataset;
            # energy_report recomputes with the calibrated rate)
            bd = energy_lib.kwn_step_energy(self.cfg.k, req.density,
                                            adc_steps=req.adc_steps)
            self._m_pj.observe(
                bd.total / energy_lib.sops_per_step(req.density))

    def submit(self, req: EventRequest) -> EventRequest:
        """Enqueue a request; returns it with ``state`` set.

        Raises a typed ``serve.lifecycle`` error (``EmptyEventError`` /
        ``EventDtypeError`` / ``EventShapeError`` / ``NonFiniteEventError``
        / ``NonTernaryEventError``) if the event tensor violates the kernel
        input contract — nothing malformed ever reaches a launch.  With a
        bounded queue (``max_pending``), an overflowing submit sheds the
        lowest-priority / newest request instead: the shed request (which
        may be ``req`` itself) gets the terminal ``REJECTED`` state and is
        recorded in ``self.rejected``.
        """
        if self.validate:
            lifecycle.validate_events(req.events, self.cfg.n_in)
        if req.density is None:
            # host-side numpy: no device dispatch/sync on the submit path
            ev = np.asarray(req.events)
            req.density = float(np.count_nonzero(ev)) / ev.size
        req._order = self._submitted
        req._t_submit = time.perf_counter()
        req.state = lifecycle.QUEUED
        self._submitted += 1
        if self.max_pending is not None and \
                len(self.pending) >= self.max_pending:
            # shed the least valuable: lowest priority, then newest arrival
            # (never shed a preempted request holding a checkpoint — its
            # work would be lost; shedding fresh work is strictly cheaper)
            victims = [r for r in self.pending + [req] if r._ckpt is None]
            victim = min(victims or [req],
                         key=lambda r: (r.priority, -r._order))
            victim.state = lifecycle.REJECTED
            self.rejected.append(victim)
            self._m_shed.inc()
            self._record_terminal(victim)
            tr = self.tracer
            if tr.enabled:
                tr.instant(f"shed req{victim.uid}", track="scheduler",
                           args={"uid": victim.uid,
                                 "priority": victim.priority})
            if victim is req:
                return req
            self.pending.remove(victim)
        self.pending.append(req)
        self._m_queue.set(len(self.pending))
        return req

    # ------------------------------------------------------------------
    # Legacy drain path (continuous=False): fixed batches, whole sequences
    # ------------------------------------------------------------------

    def _run_batch(self, reqs: list[EventRequest]) -> list[EventRequest]:
        tr = self.tracer
        batch_span = tr.begin("legacy_batch", track="scheduler")
        ev = np.zeros((self.b,) + np.asarray(reqs[0].events).shape,
                      np.float32)
        for i, r in enumerate(reqs):
            ev[i] = np.asarray(r.events, np.float32)
        seed = _derived_seed(self._seed, _TAG_BATCH, self._batches)
        self._batches += 1
        logits, tele = snn_lib.forward_silicon(
            self.params, torch.from_numpy(ev), self.cfg, seed,
            noise=self.noise, device=self.device)
        logits = logits.cpu()
        preds = logits.argmax(-1)
        adc, sops = tele["adc_steps"].cpu(), tele["sops"].cpu()
        skipped = tele["skipped_block_ratio"].cpu()
        t_done = time.perf_counter()
        for i, req in enumerate(reqs):
            req.logits = logits[i]
            req.pred = int(preds[i])
            req.adc_steps = float(adc[i])
            req.sops = float(sops[i])
            req.skipped_block_ratio = float(skipped[i])
            if req._t_submit is not None:
                req.latency_ms = (t_done - req._t_submit) * 1e3
            req.state = lifecycle.COMPLETED
            if req.deadline_ms is not None and req.latency_ms is not None:
                req.deadline_missed = req.latency_ms > req.deadline_ms
            self.completed.append(req)
            self._record_terminal(req)
            self._observe_completed(req)
        tr.end(batch_span,
               args={"batch": len(reqs)} if batch_span is not None else None)
        return reqs

    def _take_bucket(self) -> list[EventRequest]:
        """Next batch off the queue: up to ``b`` requests sharing one T.

        The legacy launch stacks whole sequences, so a batch must be
        rectangular; bucketing by stream length keeps results exact.
        """
        t0 = np.asarray(self.pending[0].events).shape[0]
        batch = [r for r in self.pending
                 if np.asarray(r.events).shape[0] == t0][:self.b]
        taken = {id(r) for r in batch}
        self.pending = [r for r in self.pending if id(r) not in taken]
        return batch

    def _run_legacy(self) -> list[EventRequest]:
        self._expire_pending()
        if self.pack_by_density:
            self.pending.sort(key=lambda r: (r.density or 0.0, r.uid))
        drained: list[EventRequest] = []
        while self.pending:
            drained.extend(self._run_batch(self._take_bucket()))
        drained.sort(key=lambda r: r._order if r._order is not None
                     else r.uid)
        return drained

    # ------------------------------------------------------------------
    # Continuous path: step-granularity rounds over persistent slots
    # ------------------------------------------------------------------

    def _request_seed(self, req: EventRequest) -> int:
        """Per-request counter-PRNG seed word, assigned at admission.

        Each request gets its own seed word (``req.seed``, else derived
        from the engine seed and the submission index through the counter
        PRNG), so its noise stream — and therefore its logits — are a pure
        function of the request, independent of co-batched traffic or
        admission order.  A one-shot ``forward_silicon(p, ev[None], cfg,
        req.seed, noise=...)`` reproduces the served result bitwise.
        """
        if req.seed is None:
            req.seed = _derived_seed(self._seed, _TAG_REQUEST, req._order)
        if self.noise is None:
            return 0              # clean serving never reads the seed word
        return int(req.seed)

    # --- deadline bookkeeping -----------------------------------------

    def _expire_pending(self) -> None:
        """Retire queued requests whose deadline has already passed.

        Only *queued* requests expire — a resident request always runs to
        completion (its work is already partly paid for; finishing late
        beats discarding mid-stream).  Expired requests reach the terminal
        ``EXPIRED`` state and land in ``self.expired``.
        """
        if not any(r.deadline_ms is not None for r in self.pending):
            return
        now = time.perf_counter()
        keep: list[EventRequest] = []
        tr = self.tracer
        for r in self.pending:
            if r.deadline_ms is not None and r._t_submit is not None and \
                    (now - r._t_submit) * 1e3 > r.deadline_ms:
                r.state = lifecycle.EXPIRED
                self.expired.append(r)
                self._m_expired.inc()
                self._record_terminal(r)
                if tr.enabled:
                    tr.instant(f"expire req{r.uid}", track="scheduler",
                               args={"uid": r.uid,
                                     "deadline_ms": r.deadline_ms})
            else:
                keep.append(r)
        self.pending = keep

    def _round_ms_estimate(self) -> float:
        """Round-time estimate feeding the deadline-risk slack math.

        Exact p95 of the recent-round sample window once at least
        ``ROUND_MS_P95_MIN_SAMPLES`` kernel rounds have been timed — the
        pessimistic tail is what slack estimation needs — falling back
        to the EMA while the window is still warming up.
        """
        n = len(self._round_samples)
        if n >= ROUND_MS_P95_MIN_SAMPLES:
            s = sorted(self._round_samples)
            return s[min(n - 1, int(n * 0.95))]
        return self._round_ms

    def _slack_ms(self, req: EventRequest, now: float) -> float:
        """Estimated deadline slack in wall ms (+inf if no deadline).

        slack = deadline - elapsed - (remaining rounds x estimated round
        time; p95 of recent rounds once warm, EMA before that — see
        ``_round_ms_estimate``).  A checkpointed request's remaining
        work starts at its recorded step offset, so a mostly-done
        preempted request reads as *less* at-risk than a fresh one with
        the same deadline.
        """
        if req.deadline_ms is None or req._t_submit is None:
            return math.inf
        elapsed = (now - req._t_submit) * 1e3
        if req._ckpt is not None:
            t, done = req._ckpt.length, req._ckpt.steps_done
        else:
            t, done = np.asarray(req.events).shape[0], 0
        est = math.ceil((t - done) / self.round_steps) \
            * self._round_ms_estimate()
        return req.deadline_ms - elapsed - est

    # --- admission ----------------------------------------------------

    def _admit(self) -> None:
        free = [i for i, r in enumerate(self._slot_req) if r is None]
        if not free or not self.pending:
            return
        # backoff gate: a freshly preempted request sits out its
        # exponential-backoff window (measured in scheduling ticks, which
        # advance even on idle rounds, so the window always expires)
        eligible = [r for r in self.pending
                    if r._not_before <= self._rounds_total]
        if not eligible:
            return
        scheduled = any(r.priority != 0 or r.deadline_ms is not None
                        or r._ckpt is not None for r in eligible)
        if scheduled:
            # urgency order: priority first, then tightest deadline slack,
            # then submission order (total order -> deterministic)
            now = time.perf_counter()
            eligible.sort(key=lambda r: (-r.priority,
                                         self._slack_ms(r, now), r._order))
        elif self.pack_by_density:
            active = [r.density or 0.0
                      for r in self._slot_req if r is not None]
            if active:
                # keep rounds density-homogeneous: nearest-density first
                target = sum(active) / len(active)
                eligible.sort(
                    key=lambda r: (abs((r.density or 0.0) - target),
                                   r._order))
            else:
                # empty batch: start from the quietest traffic
                eligible.sort(key=lambda r: (r.density or 0.0, r._order))
        chosen = eligible[:len(free)]
        taken = {id(r) for r in chosen}
        self.pending = [r for r in self.pending if id(r) not in taken]
        mask = np.zeros(self.b, bool)
        tr = self.tracer
        for slot, req in zip(free, chosen):
            self._slot_req[slot] = req
            self._slot_admit_round[slot] = self._rounds_total
            req.state = lifecycle.RUNNING
            self._m_admitted.inc()
            if tr.enabled:
                # residency span: one lane per slot, open until the
                # request leaves the slot (evict or preempt)
                req._span = tr.begin(
                    f"req{req.uid}", track=f"slot{slot:02d}",
                    args={"uid": req.uid, "priority": req.priority,
                          "resumed": req._ckpt is not None})
            if req._ckpt is not None:
                if req._t_preempt_out is not None:
                    # checkpoint dwell: wall time spent off-device since
                    # the preemption that produced this checkpoint
                    req.preempted_ms += (time.perf_counter() -
                                         req._t_preempt_out) * 1e3
                    req._t_preempt_out = None
                # re-admission: update the host shadows *first*, then push
                # the checkpoint into the slot.  Order matters — the
                # masked admit below rewrites the full length/seed vectors
                # from these shadows, so they must already carry the
                # restored values when fresh admits share this pass.
                ck = req._ckpt
                self._slot_len[slot] = ck.length
                self._slot_done[slot] = ck.steps_done
                self._slot_seed[slot] = ck.seed
                self._state = snn_lib.silicon_stream_restore(
                    self._state, slot, ck)
                req._ckpt = None
            else:
                self._slot_len[slot] = np.asarray(req.events).shape[0]
                self._slot_done[slot] = 0
                self._slot_seed[slot] = self._request_seed(req)
                mask[slot] = True
        if mask.any():
            self._state = snn_lib.silicon_stream_admit(
                self._state, mask, self._slot_len, self._slot_seed)

    # --- preemption ---------------------------------------------------

    def _preempt_slot(self, slot: int, backoff: bool = True) -> EventRequest:
        """Checkpoint slot ``slot`` to host memory and requeue its request."""
        req = self._slot_req[slot]
        req._ckpt = snn_lib.silicon_stream_save(self._state, slot)
        req.state = lifecycle.PREEMPTED
        req.preemptions += 1
        req._t_preempt_out = time.perf_counter()
        self.preemption_count += 1
        self._m_preempted.inc()
        if req._span is not None:
            self.tracer.end(req._span, args={"outcome": "preempted",
                                             "steps_done":
                                                 int(self._slot_done[slot])})
            req._span = None
        if backoff:
            req._not_before = (self._rounds_total + self.backoff_rounds *
                               2 ** (req.preemptions - 1))
        self._slot_req[slot] = None
        self.pending.append(req)
        return req

    def _maybe_preempt(self) -> None:
        """One scheduling decision: preempt at most one slot per tick.

        Fires only when the batch is full, the best eligible queued
        request outranks the weakest resident one (strictly higher
        priority, or deadline-at-risk at >= priority), and the victim has
        been resident at least ``preempt_quantum`` ticks with fewer than
        ``max_preemptions`` prior preemptions.  The one-per-tick cap plus
        quantum plus exponential backoff is the anti-thrash budget.
        """
        if not (self.preemptive and self.continuous and self.pending):
            return
        if any(r is None for r in self._slot_req):
            return                      # a free slot: admission handles it
        eligible = [r for r in self.pending
                    if r._not_before <= self._rounds_total]
        if not eligible:
            return
        now = time.perf_counter()
        cand = min(eligible, key=lambda r: (-r.priority,
                                            self._slack_ms(r, now),
                                            r._order))
        victims = [(i, r) for i, r in enumerate(self._slot_req)
                   if self._rounds_total - self._slot_admit_round[i]
                   >= self.preempt_quantum
                   and r.preemptions < self.max_preemptions]
        if not victims:
            return
        # weakest resident: lowest priority, then longest resident
        slot, victim = min(victims,
                           key=lambda iv: (iv[1].priority,
                                           self._slot_admit_round[iv[0]],
                                           iv[1]._order))
        margin = (2.0 * self._round_ms_estimate()
                  if self.risk_margin_ms is None else self.risk_margin_ms)
        at_risk = self._slack_ms(cand, now) < margin
        if cand.priority > victim.priority or \
                (at_risk and cand.priority >= victim.priority):
            self._preempt_slot(slot)

    def preempt_request(self, uid: int, at_step: int | None = None,
                        backoff: bool = True) -> EventRequest:
        """Force-preempt a resident request (fault-injection / test hook).

        With ``at_step`` the stream is first advanced to exactly that
        absolute offset — including offsets that are *not* multiples of
        ``round_steps`` — by running partial rounds (the whole batch
        advances together, so every co-resident slot stays bitwise-exact;
        see ``forward_silicon_stream``).  The slot is then checkpointed to
        host memory and the request requeued (``PREEMPTED``).  Call it
        from a ``run(round_hook=...)`` callback to inject preemptions at
        randomized offsets mid-serve.
        """
        if not self.continuous:
            raise RuntimeError("preemption requires the continuous path")
        slot = next((i for i, r in enumerate(self._slot_req)
                     if r is not None and r.uid == uid), None)
        if slot is None:
            raise KeyError(f"request {uid} is not resident in any slot")
        if at_step is not None:
            done, length = int(self._slot_done[slot]), \
                int(self._slot_len[slot])
            if not done <= at_step < length:
                raise ValueError(
                    f"at_step={at_step} outside [{done}, {length}) for "
                    f"request {uid}")
            while int(self._slot_done[slot]) < at_step:
                self._round(min(self.round_steps,
                                at_step - int(self._slot_done[slot])))
        return self._preempt_slot(slot, backoff=backoff)

    def _round(self, r: int | None = None) -> None:
        """Advance every occupied slot by ``r`` time steps (one launch).

        ``r`` defaults to the regular ``round_steps`` cadence; smaller
        values are the *partial rounds* the preemption path uses to stop a
        stream at a non-round-aligned offset (each distinct ``r`` compiles
        one more launch shape, bounded by ``round_steps``).
        """
        r = self.round_steps if r is None else r
        span = self.tracer.begin("round", track="scheduler")
        ev = np.zeros((r, self.b, self.cfg.n_in), np.float32)
        for i, req in enumerate(self._slot_req):
            if req is None:
                continue
            chunk = np.asarray(req.events,
                               np.float32)[self._slot_done[i]:
                                           self._slot_done[i] + r]
            ev[:chunk.shape[0], i, :] = chunk
        self._state = snn_lib.forward_silicon_stream(
            self.params, torch.from_numpy(ev).to(self.device), self.cfg,
            self._state, noise=self.noise, fw=self._fw)
        self._slot_done = np.minimum(self._slot_done + r, self._slot_len)
        self._m_rounds.inc()
        if span is not None:
            self.tracer.end(span, args={"steps": r, "active": self.active})

    def _evict(self) -> list[EventRequest]:
        out: list[EventRequest] = []
        w_out = self.params["w_out"]
        for i, req in enumerate(self._slot_req):
            if req is None or self._slot_done[i] < self._slot_len[i]:
                continue
            length = int(self._slot_len[i])
            # batch-1 shaped readout: bitwise-matches the one-shot path
            logits = f32math.div(self._state.counts[i][None], length) @ w_out
            req.logits = logits[0].cpu()
            req.pred = int(req.logits.argmax())
            # f32 division: matches the one-shot telemetry normalization
            # bit for bit (tele / t_steps is an f32 division there too)
            lf = np.float32(length)
            acc = lambda a: np.float32(float(a[i]))   # exact: f32 on device
            req.adc_steps = float(acc(self._state.adc) / lf)
            req.sops = float(acc(self._state.sops) / lf)
            req.skipped_block_ratio = float(acc(self._state.skip_acc) / lf)
            if req._t_submit is not None:
                req.latency_ms = (time.perf_counter() -
                                  req._t_submit) * 1e3
            req.state = lifecycle.COMPLETED
            if req.deadline_ms is not None and req.latency_ms is not None:
                req.deadline_missed = req.latency_ms > req.deadline_ms
            self._slot_req[i] = None
            self.completed.append(req)
            self._m_evicted.inc()
            self._record_terminal(req)
            self._observe_completed(req)
            if req._span is not None:
                self.tracer.end(req._span,
                                args={"outcome": "completed",
                                      "latency_ms": req.latency_ms,
                                      "preemptions": req.preemptions})
                req._span = None
            out.append(req)
        return out

    @property
    def active(self) -> int:
        """Occupied slot count (continuous path)."""
        return sum(r is not None for r in self._slot_req)

    def run(self, max_rounds: int | None = None,
            round_hook: Callable[["SNNEventEngine"], None] | None = None
            ) -> list[EventRequest]:
        """Serve the queue; returns the requests completed by *this* call,
        in submission order.

        Continuous path (default): rounds of ``round_steps`` time steps
        over the persistent slot batch — new requests are admitted into
        free slots *between rounds* (density-aware when
        ``pack_by_density``, urgency-ordered when any queued request
        carries a priority/deadline), finished requests are evicted as
        soon as their own stream ends, and the per-slot LIF membrane
        carries across rounds on device.  Each tick also expires
        dead-on-arrival queued requests and makes at most one preemption
        decision (see ``_maybe_preempt``).  ``max_rounds`` bounds this
        call (leaving unfinished requests resident for the next
        ``run()``).  ``round_hook(engine)``, if given, fires after every
        tick's eviction — the chaos harness uses it to inject forced
        preemptions at arbitrary step offsets mid-serve.

        Legacy path (``continuous=False``): drains in fixed whole-sequence
        batches, bucketed by stream length.

        Either way the returned list covers only requests drained by this
        call — history accumulates in ``self.completed`` (and
        ``self.expired`` / ``self.rejected`` for the shed paths) — and
        scheduling never leaks into result order (always submission
        order) or result values (noise is per-request on the continuous
        path; the legacy key stream is per-batch as before).
        """
        if not self.continuous:
            return self._run_legacy()
        drained: list[EventRequest] = []
        tr = self.tracer
        rounds = 0
        while self.pending or self.active:
            if max_rounds is not None and rounds >= max_rounds:
                break
            tick = tr.begin("tick", track="scheduler")
            h = tr.begin("expire", track="scheduler")
            self._expire_pending()
            tr.end(h)
            if not (self.pending or self.active):
                tr.end(tick)
                break
            h = tr.begin("preempt", track="scheduler")
            self._maybe_preempt()
            tr.end(h)
            h = tr.begin("admit", track="scheduler")
            self._admit()
            tr.end(h)
            self._m_queue.set(len(self.pending))
            self._m_occupancy.set(self.active)
            ran = self.active > 0
            t0 = time.perf_counter()
            if ran:
                self._round()
            h = tr.begin("evict", track="scheduler")
            drained.extend(self._evict())
            tr.end(h)
            if ran:
                # round-time estimators, fed only by ticks that launched
                # a kernel (idle ticks are microseconds and would poison
                # the slack estimates): EMA for warmup, an exact sample
                # window for p50/p95, and the mergeable histogram export
                dt = (time.perf_counter() - t0) * 1e3
                self._round_ms = (
                    dt if self._round_ms == 0.0
                    else ROUND_MS_EMA_DECAY * self._round_ms +
                    (1.0 - ROUND_MS_EMA_DECAY) * dt)
                self._round_samples.append(dt)
                self._m_round_ms.observe(dt)
            if round_hook is not None:
                round_hook(self)
                drained.extend(self._evict())
            # tick advances even when idle: backoff windows are measured
            # in ticks and must expire with zero active slots too
            self._rounds_total += 1
            rounds += 1
            tr.end(tick)
        drained.sort(key=lambda r: r._order if r._order is not None
                     else r.uid)
        return drained

    def energy_report(self, dataset: str) -> dict:
        """Serving-side energy estimate from *measured* early-stop statistics.

        Uses the calibrated per-component model (core.energy) but replaces
        the analytic early-stop saving with the mean ADC step count the KWN
        controller actually reported for the served traffic.

        Every statistic in the report — ADC steps, energy, and the
        skipped-block ratio — is computed over the same population: the
        completed requests that carry measured ``adc_steps``.  Returns
        ``{}`` (documented contract, not an error) when there is nothing
        to report: no completed KWN request with measured ADC statistics,
        or the engine serves NLD mode, whose ramp always runs all
        2**code_bits - 1 steps so there is no measured early-stop to
        report.

        Besides the population means, the report carries a
        ``per_request`` table (one row per completed request: uid,
        latency, measured ADC steps, per-request pJ/SOP from *that
        request's* early-stop statistics, density) and — when latencies
        were measured — the serving SLO summary ``latency_ms_mean`` /
        ``latency_ms_p50`` / ``latency_ms_p95``.
        """
        done = [r for r in self.completed if r.adc_steps is not None]
        if not done or self.cfg.mode != "kwn":
            return {}
        if dataset not in energy_lib.SPIKE_RATES:
            raise ValueError(
                f"unknown dataset {dataset!r} for the calibrated spike rate; "
                f"expected one of {sorted(energy_lib.SPIKE_RATES)}")
        mean_steps = sum(r.adc_steps for r in done) / len(done)
        full = 2 ** self.cfg.code_bits - 1
        spike_rate = energy_lib.SPIKE_RATES[dataset]
        bd = energy_lib.kwn_step_energy(self.cfg.k, spike_rate,
                                        adc_steps=mean_steps)
        rep = {
            "requests": len(done),
            "mean_adc_steps": mean_steps,
            "measured_adc_saving": 1.0 - mean_steps / full,
            "pj_per_step": bd.total,
            "pj_per_sop": bd.total / energy_lib.sops_per_step(spike_rate),
        }
        # same population as the ADC/energy stats above — a request that
        # carries a skip ratio but no adc_steps must not dilute the mean
        skipped = [r.skipped_block_ratio for r in done
                   if r.skipped_block_ratio is not None]
        if skipped:
            # measured activity-plan saving, next to the early-stop saving
            rep["mean_skipped_block_ratio"] = sum(skipped) / len(skipped)
        sops_ps = energy_lib.sops_per_step(spike_rate)
        rep["per_request"] = [
            {"uid": r.uid,
             "latency_ms": r.latency_ms,
             # checkpoint dwell: wall ms spent checkpointed off-device.
             # latency_ms includes it, so fairness analysis can separate
             # "ran slowly" from "sat preempted" per request.
             "preempted_ms": r.preempted_ms,
             "adc_steps": r.adc_steps,
             "pj_per_sop": energy_lib.kwn_step_energy(
                 self.cfg.k, spike_rate,
                 adc_steps=r.adc_steps).total / sops_ps,
             "density": r.density}
            for r in done]
        lat = sorted(r.latency_ms for r in done if r.latency_ms is not None)
        if lat:
            rep["latency_ms_mean"] = sum(lat) / len(lat)
            rep["latency_ms_p50"] = lat[len(lat) // 2]
            rep["latency_ms_p95"] = lat[min(len(lat) - 1,
                                            int(len(lat) * 0.95))]
        if self._round_samples:
            # exact quantiles over the recent kernel-round window (the
            # same samples that feed the round_ms histogram metric and
            # the deadline-slack p95) — replaces squinting at the EMA
            rs = sorted(self._round_samples)
            rep["round_ms_p50"] = rs[len(rs) // 2]
            rep["round_ms_p95"] = rs[min(len(rs) - 1,
                                         int(len(rs) * 0.95))]
        # serving SLO ledger: every submission's fate is visible here
        rep["preemptions"] = self.preemption_count
        rep["rejected"] = len(self.rejected)
        rep["expired"] = len(self.expired)
        rep["deadline_misses"] = sum(
            1 for r in self.completed if r.deadline_missed)
        return rep


class BatchedEngine:
    """Minimal continuous-batching LM engine: fixed B slots, requests are
    admitted as slots free, prefill runs token by token through the decode
    step (teacher forcing), then decode until each request completes.

    The admission, position and ``max_rounds`` semantics are the
    reference's: a prompt token steps the whole batch (the other slots
    rewrite the K/V they will write again at their next decode), and
    ``max_rounds`` budgets decode rounds only.  Decoding is greedy.  Runs
    on ``cuda`` unless the caller passes ``device="cpu"``.
    """

    def __init__(self, cfg: lm.LMConfig, params, batch_slots: int = 4,
                 s_max: int = 256, device=None):
        dev = device_lib.resolve(device)
        self.cfg = cfg
        self.params = params
        self.b = batch_slots
        self.s_max = s_max
        self.device = dev
        self.step_fn = build_serve_step(cfg)
        self.cache = lm.init_cache(cfg, batch_slots, s_max, device=dev)
        self.pos = torch.zeros((batch_slots,), dtype=torch.int64, device=dev)
        self.slots: list[Request | None] = [None] * batch_slots
        self.pending: list[Request] = []
        self.completed: list[Request] = []
        self._next_token = torch.zeros((batch_slots, 1), dtype=torch.int32,
                                       device=dev)
        self._gen = torch.Generator(dev).manual_seed(0)

    def submit(self, req: Request):
        self.pending.append(req)

    def _admit(self):
        for i in range(self.b):
            if self.slots[i] is None and self.pending:
                req = self.pending.pop(0)
                self.slots[i] = req
                for t, tok in enumerate(req.prompt):
                    toks = self._next_token.clone()
                    toks[i, 0] = tok
                    pos = self.pos.clone()
                    pos[i] = t
                    nxt, _, self.cache = self.step_fn(
                        self.params, self.cache, toks, pos, self._gen)
                    self._next_token[i] = nxt[i]
                self.pos[i] = len(req.prompt)

    def run(self, max_rounds: int = 64):
        # max_rounds budgets *decode* rounds: admission / prefill work is
        # never charged against it
        rounds = 0
        while self.pending or any(self.slots):
            self._admit()
            if not any(self.slots):
                break
            if rounds >= max_rounds:
                break
            rounds += 1
            nxt, _, self.cache = self.step_fn(self.params, self.cache,
                                              self._next_token, self.pos,
                                              self._gen)
            self._next_token = nxt
            self.pos += torch.tensor(
                [1 if s is not None else 0 for s in self.slots],
                dtype=self.pos.dtype, device=self.device)
            toks, pos = nxt[:, 0].tolist(), self.pos.tolist()
            for i, req in enumerate(self.slots):
                if req is None:
                    continue
                req.generated.append(toks[i])
                if req.done or pos[i] >= self.s_max - 1:
                    self.completed.append(req)
                    self.slots[i] = None
        return self.completed
