"""Shared measurement instruments: the timing loop and the event streams.

Counterpart of ``repro.tune.measure``.  The tuner's medians and a bench's
must come from one stopwatch, so both live here:

* ``median_us`` / ``median_ms``: the median of ``iters`` timed calls after
  one warm-up call.  On a CUDA device each call is timed by a pair of CUDA
  events on the current stream (the warm-up call, which absorbs the lazy
  ``nvcc`` build of a kernel's first launch, is synchronised and never
  counted); on the CPU by ``time.perf_counter``.
* ``event_stream``: the bursty (DVS-like) ternary stream of the reference,
  as a function of explicit draws (``event_stream_from_draws``) plus a
  numpy-seeded wrapper.  Handing the reference's own ``jax.random`` draws
  to ``event_stream_from_draws`` gives its stream bit for bit.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.obs import trace as obs_trace

# Per-element event rate inside an active (burst) step of a DVS-like
# stream: the bench's density sweep and the tuner's measurements share it,
# since the skipped-block ratio of a plan depends on it.
IN_BURST_DENSITY = 0.2


def _sync(out) -> None:
    """Wait for every CUDA tensor in ``out`` (a tensor or a nest of them)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, (tuple, list)):
        for o in out:
            _sync(o)


def _device_of(fn_args) -> torch.device | None:
    for a in fn_args:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            return a.device
    return None


def median_us(fn, args, iters: int = 20, label: str | None = None) -> float:
    """Median per-call time of ``fn(*args)`` in microseconds over ``iters``
    timed calls, after one synchronised warm-up call.

    A CUDA tensor among ``args`` times each call with CUDA events on that
    device's current stream (the host's launch work and the kernels, not
    the idle time before the first launch); otherwise the host clock
    times each call to its return.  One ``measure`` span on the
    ``measure`` track of the process tracer (when enabled) covers the
    warm-up and the timed calls and carries the median; ``label`` names it.
    """
    tr = obs_trace.get_tracer()
    span = tr.begin(label or "measure", track="measure")
    dev = _device_of(args)
    out = fn(*args)                       # build, load and warm up
    _sync(out)
    if dev is not None:
        torch.cuda.synchronize(dev)
    samples = []
    for _ in range(iters):
        if dev is not None:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            stop.record()
            stop.synchronize()
            samples.append(start.elapsed_time(stop) * 1e-3)
        else:
            t0 = time.perf_counter()
            out = fn(*args)
            _sync(out)
            samples.append(time.perf_counter() - t0)
    us = float(np.median(samples)) * 1e6
    if span is not None:
        tr.end(span, args={"iters": iters, "median_us": us})
    return us


def median_ms(fn, args, iters: int = 20, label: str | None = None) -> float:
    """``median_us`` in milliseconds: the unit the plan cache persists."""
    return median_us(fn, args, iters=iters, label=label) * 1e-3


def event_stream_from_draws(tern, u_el, u_step, density: float) -> np.ndarray:
    """Density-d ternary events from explicit draws: ``tern`` the ternary
    values (any shape), ``u_el`` per-element uniforms in [0, 1) of that
    shape, ``u_step`` (T, 1, 1) per-step uniforms (read only for a bursty
    3-D stream); all f32.

    A (T, M, K) stream below the in-burst rate is silent steps plus
    active ones (probability ``density / IN_BURST_DENSITY``) that fire at
    the in-burst rate; at or above it, and for 2-D shapes, every element
    fires with probability ``density``.  The thresholds are compared in
    f32, as the reference compares its f32 draws.  Returns int8.
    """
    tern = np.asarray(tern)
    u_el = np.asarray(u_el, np.float32)
    if tern.ndim == 3 and density < IN_BURST_DENSITY:
        active = np.asarray(u_step, np.float32) \
            < np.float32(density / IN_BURST_DENSITY)
        sparse = (u_el < np.float32(IN_BURST_DENSITY)) & active
    else:
        sparse = u_el < np.float32(density)
    return (tern * sparse).astype(np.int8)


def event_stream(rs, density: float, shape) -> np.ndarray:
    """``event_stream_from_draws`` on draws from ``rs`` (a
    ``numpy.random.RandomState``, or a seed for one): the ternary values,
    then the per-element and the per-step uniforms."""
    if not isinstance(rs, np.random.RandomState):
        rs = np.random.RandomState(rs)
    shape = tuple(shape)
    tern = rs.randint(-1, 2, size=shape).astype(np.int8)
    u_el = rs.random_sample(shape).astype(np.float32)
    u_step = rs.random_sample((shape[0], 1, 1)).astype(np.float32)
    return event_stream_from_draws(tern, u_el, u_step, density)
