"""The per-layer readings of a run, for the readers in ``metrics/``.

Each takes the run's ``Context`` and the phase its metric belongs to
(``"eval"`` or ``"train"``), and returns None where the run has nothing
of that phase to read (the other phase's cells, or an untraced run).
The layers are the port's modules from the entry point down:

* model entry, ``models/snn.py`` (``forward_silicon``, ``train_step``):
  the host's time in the call, from the benchmark's own span;
* model step, the whole call: its share of the card's peak (``mfu``);
* seam, ``core/{macro,ternary,prbs}.py`` and ``kernels/ops.py`` (and
  autograd's plain ops in training): the device time of every operation
  that is not one of the port's own kernels, and the kernels a call
  launches;
* kernels, ``kernels/fused_macro{,_grad}.py`` and ``csrc/*.cu``: the
  macro's share of its roofline over the port's own kernels' time, and
  the share of activity tiles the kernel skipped;
* device: the share of the window in which nothing ran on the card.
"""

from __future__ import annotations

from cimbench import counts, stats


def _traced(ctx, phase: str):
    return ctx.trace if ctx.phase == phase and ctx.trace is not None \
        and ctx.trace.calls else None


def host_ms_per_call(ctx, phase: str):
    """The median host time of a call, from its start to its return
    before the synchronise."""
    if ctx.phase != phase:
        return None
    return stats.median(ctx.window.host_ms())


def mfu(ctx, phase: str):
    """The least time the card's peak rates need for the call's products,
    over the median call (start to synchronised result), in %."""
    if ctx.phase != phase or ctx.peak is None:
        return None
    ops_s, _ = counts.ideal_seconds(ctx.work, ctx.peak)
    return 100.0 * ops_s / (1e-3 * stats.median(ctx.window.call_ms()))


def seam_device_ms(ctx, phase: str):
    """Device ms a call of every operation but the port's own kernels."""
    tr = _traced(ctx, phase)
    if tr is None:
        return None
    return 1e3 * tr.device_s(lambda n: n not in ctx.port) / tr.calls


def device_kernels_per_call(ctx, phase: str):
    tr = _traced(ctx, phase)
    return None if tr is None else tr.kernels() / tr.calls


def macro_roofline(ctx, phase: str):
    """The macro's bound (its products at the peak rates or its bytes at
    the peak bandwidth, the larger) over the device time of the port's
    own kernels a call, in %; None where none of them ran."""
    tr = _traced(ctx, phase)
    if tr is None or ctx.peak is None:
        return None
    own_s = tr.device_s(lambda n: n in ctx.port, kernels_only=True)
    if own_s <= 0:
        return None
    return 100.0 * max(counts.ideal_seconds(ctx.work, ctx.peak)) \
        / (own_s / tr.calls)


def device_idle_share(ctx, phase: str):
    """The share of the traced window with no device operation, in %."""
    tr = _traced(ctx, phase)
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
