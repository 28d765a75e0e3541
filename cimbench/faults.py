"""Faults planted under the timed path, for showing that the comparison
catches them (``checks/test_cimbench_faults.py``) and for reading how
far each moves the numbers compared (``calibrate.py``).

A runner kind's ``FAULTS`` maps each fault its cells can have to a
``patched(...)`` context built from the wrappers here, which replace a
function of the program for the context's extent:

* ``stale_seq`` / ``stale_step``: the step returns its state unchanged:
  the fused kernel's membrane never advances (no spike), or the training
  step hands back the parameters it was given;
* ``half_forward`` / ``half_step``: half of the batch left out: the pass
  computes the first half of the streams and fills the rest with their
  mean, the training step steps on the first half of its batch;
* ``altered_forward``: one stream's answer altered where it is produced
  (its least likely class raised above its most likely).
"""

from __future__ import annotations

import contextlib
import importlib

import torch


@contextlib.contextmanager
def patched(module: str, name: str, make):
    """``module.name`` replaced by ``make(original)`` for the extent."""
    mod = importlib.import_module(module)
    original = getattr(mod, name)
    setattr(mod, name, make(original))
    try:
        yield
    finally:
        setattr(mod, name, original)


def stale_seq(fused_seq):
    def run(spikes, fw, v, *args, **kw):
        v_out, spk, mask, steps, mac = fused_seq(spikes, fw, v, *args, **kw)
        return v, torch.zeros_like(spk), mask, steps, mac
    return run


def half_forward(forward):
    def run(p, events, cfg, *args, **kw):
        half = events.shape[0] // 2
        logits, tele = forward(p, events[:half], cfg, *args, **kw)
        rest = events.shape[0] - half

        def fill(a):
            return torch.cat([a, a.float().mean(0, keepdim=True)
                              .expand(rest, *a.shape[1:]).to(a.dtype)])
        return fill(logits), {k: fill(v) for k, v in tele.items()}
    return run


def altered_forward(forward):
    def run(*args, **kw):
        logits, tele = forward(*args, **kw)
        logits = logits.clone()
        logits[0, logits[0].argmin()] = logits[0].max() + 1.0
        return logits, tele
    return run


def stale_step(train_step):
    def run(p, opt_m, *args, **kw):
        _, opt_m, loss = train_step(p, opt_m, *args, **kw)
        return p, opt_m, loss
    return run


def half_step(train_step):
    def run(p, opt_m, events, labels, *args, **kw):
        half = events.shape[0] // 2
        return train_step(p, opt_m, events[:half], labels[:half], *args,
                          **kw)
    return run
