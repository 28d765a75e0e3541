"""Training: ``snn.train_step(silicon=True)`` a call, with the Fig. 7
noise and a fresh counter seed a step, on batches drawn at set-up and
cycled.

Set-up builds the one (parameters, momentum) state, drives it through
the first ``SETUP_STEPS`` steps with the window's own call, and hands it
on to the window, which goes on from there.  After each window step the
state is copied, so that once the window has closed the state before
its last step and after it are both at hand.

What decides ``correct``: the reference follows the set-up's steps from
the same raw weights, batches and step seeds, and takes the window's
last step from the program's state before it, with that step's batch
and seed.  ``loss_gap`` is the largest relative gap of a step's loss;
``grad_gap`` and ``update_gap`` take the worst leaf
(``check.worst_leaf``) of the gradient as the optimizer got it (the
momentum after step 0; the momentum's change over the last step, ``m -
0.9 m_before``) and of the parameters' change (over the set-up's steps;
over the last step).  Each is the larger of the set-up's reading and the
last step's.  The control is the reference on TF32 products in the
program's place.
"""

from __future__ import annotations

import torch

from cimbench import check, counts, faults, weights
from cimbench import events as events_lib
from cimbench.reference import macro as ref
from cimbench.runners import mix

SETUP_STEPS = 3
MOMENTUM = 0.9     # the program's and the reference's SGD momentum

FAULTS = {
    "stale_state": lambda: faults.patched(
        "repro_torch.models.snn", "train_step", faults.stale_step),
    "half_batch": lambda: faults.patched(
        "repro_torch.models.snn", "train_step", faults.half_step),
}


def _copy(d: dict) -> dict:
    return {k: a.clone() for k, a in d.items()}


class Runner:
    phase = "train"

    def __init__(self, config: dict, traffic: dict, seed: int, dev):
        from repro_torch.models import snn

        self.snn_mod = snn
        self.config, self.traffic, self.seed, self.dev = (config, traffic,
                                                          seed, dev)
        self.cfg = snn.SNNConfig(**config["snn"])
        self.noise = weights.program_noise(traffic)
        self.units = traffic["batch"]
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.raw = weights.make_weights(config["snn"], gen, dev)
        streams = events_lib.EventStreams(traffic["data"], dev)
        self.batches = [streams.sample(gen, self.units)
                        for _ in range(traffic["batches"])]
        self.p = weights.program_params(self.raw)
        self.m = {k: torch.zeros_like(a) for k, a in self.p.items()}
        self.steps = 0
        self.losses = []
        for _ in range(SETUP_STEPS):
            self.losses.append(float(self.call(None)[1]))
            if self.steps == 1:      # m = 0.9 * 0 + g: the first gradient
                self.first_grad = _copy(self.m)
        self.after_setup = _copy(self.p)
        self.before = None
        self.last = (self.steps - 1, self.after_setup, _copy(self.m), None)

    def step_seed(self, step: int) -> int:
        """The counter seed of ``step``, in [0, 2^23) as
        ``train.silicon.step_seed`` draws them."""
        return mix(self.seed, step, 2) >> 8

    def batch(self, step: int):
        return self.batches[step % len(self.batches)]

    def call(self, i):
        """The next step, whatever the window's index ``i``; returns (its
        step number, its loss)."""
        step = self.steps
        ev, lab = self.batch(step)
        self.p, self.m, loss = self.snn_mod.train_step(
            self.p, self.m, ev, lab, self.cfg, self.traffic["lr"],
            self.step_seed(step), silicon=True, noise=self.noise,
            kwn_relax=self.traffic["kwn_relax"])
        self.steps += 1
        return step, loss

    def keep(self, i: int, out) -> None:
        """The state before the newest step and after it."""
        step, loss = out
        self.before = self.last
        self.last = (step, _copy(self.p), _copy(self.m), loss)

    def telemetry(self) -> dict:
        return {}

    def work(self) -> dict:
        return counts.macro_work(self.config["snn"], self.units,
                                 self.noise is not None, train=True)

    def _reference_setup(self, tf32: bool) -> tuple:
        return ref.train_steps(
            self.raw, self.batches[:SETUP_STEPS],
            [self.step_seed(s) for s in range(SETUP_STEPS)],
            self.config["snn"], self.traffic["lr"],
            weights.reference_noise(self.traffic),
            self.traffic["kwn_relax"], tf32)

    def _reference_last(self, tf32: bool) -> tuple:
        """The reference's last window step from the program's state
        before it: (loss, gradient, parameters after)."""
        step, p, m, _ = self.before
        ev, lab = self.batch(step + 1)
        loss, g, p_new, _ = ref.train_step(
            p, m, ev, lab, self.step_seed(step + 1), self.config["snn"],
            self.traffic["lr"], weights.reference_noise(self.traffic),
            self.traffic["kwn_relax"], tf32)
        return loss, g, p_new

    def _numbers(self, setup: tuple, last: tuple) -> dict:
        """The numbers of ``setup`` (losses, first gradient, parameters
        after the set-up) and ``last`` (the last step's loss, gradient,
        parameters after) against the reference's."""
        losses, grad, after = setup
        r_losses, r_grad, r_after = self._reference_setup(False)
        loss, g, p_new = last
        r_loss, r_g, r_p = self._reference_last(False)
        p_before = self.before[1]

        def change(p, start):
            return {k: p[k].double() - start[k].double() for k in r_after}

        return {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(losses + [loss], r_losses + [r_loss])),
            "grad_gap": max(check.worst_leaf(grad, r_grad),
                            check.worst_leaf(g, r_g)),
            "update_gap": max(
                check.worst_leaf(change(after, self.raw),
                                 change(r_after, self.raw)),
                check.worst_leaf(change(p_new, p_before),
                                 change(r_p, p_before))),
        }

    def numbers(self) -> dict:
        _, p_before, m_before, _ = self.before
        _, p_after, m_after, loss = self.last
        grad = {k: m_after[k].double() - (MOMENTUM * m_before[k]).double()
                for k in m_after}
        return self._numbers(
            (self.losses, self.first_grad, self.after_setup),
            (float(loss), grad, p_after))

    def control_numbers(self) -> dict:
        return self._numbers(self._reference_setup(True),
                             self._reference_last(True))
