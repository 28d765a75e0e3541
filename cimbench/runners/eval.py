"""Inference: one pass of a test set resident on the card through
``forward_silicon(fused="seq")`` a call.

Set-up draws ``test_sets`` test sets of ``streams`` streams each from the
seed, on the card, and the window's i-th call passes set ``i mod
test_sets``: no call sees the input of the call before it, so a cache
keyed on the input gains only where it holds every set.  Clean traffic
passes seed 0 (the PRBS-15 stream, which no seed moves); noisy traffic a
fresh seed a call, from ``--seed`` and the call's index.

What decides ``correct``: for every pass kept from the window
(``RESERVOIR`` drawn from the seed, and the last), the reference runs
over the same test set with the same weights and seed, and one number
is read: ``output_gap``, the widest gap over the pass's outputs, each
output's largest absolute difference over its largest reference value
(1 where that is 0): the logits, and the telemetry (each stream's mean
ADC steps, LIF updates and SOPs, the skipped share of activity tiles).
The telemetry is integer counts over T, so one count off reads 1e-3 or
more of its scale, and a lower precision of the products moves only the
logits: one number over both is what separates the sound program from
the control, the reference on TF32 products.
"""

from __future__ import annotations

import random

import torch

from cimbench import check, counts, faults, weights
from cimbench import events as events_lib
from cimbench.reference import macro as ref
from cimbench.runners import mix, sync

RESERVOIR = 3      # window passes kept for the comparison, besides the last

FAULTS = {
    "stale_state": lambda: faults.patched(
        "repro_torch.core.macro", "fused_seq", faults.stale_seq),
    "half_batch": lambda: faults.patched(
        "repro_torch.models.snn", "forward_silicon", faults.half_forward),
    "answer_altered": lambda: faults.patched(
        "repro_torch.models.snn", "forward_silicon", faults.altered_forward),
}


class Runner:
    phase = "eval"

    def __init__(self, config: dict, traffic: dict, seed: int, dev):
        from repro_torch.models import snn

        self.snn_mod = snn
        self.config, self.traffic, self.seed, self.dev = (config, traffic,
                                                          seed, dev)
        self.cfg = snn.SNNConfig(**config["snn"])
        self.noise = weights.program_noise(traffic)
        self.units = traffic["streams"]
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.raw = weights.make_weights(config["snn"], gen, dev)
        self.params = weights.program_params(self.raw)
        streams = events_lib.EventStreams(traffic["data"], dev)
        self.sets = [streams.sample(gen, self.units)[0]
                     for _ in range(traffic["test_sets"])]
        self.outputs: dict = {}
        self._pick = random.Random(f"{seed}:reservoir")
        for i in (-2, -1):                 # builds, loads and warms #1 / #2
            self.call(i)
        sync(dev)

    def events(self, i: int) -> torch.Tensor:
        return self.sets[i % len(self.sets)]

    def call_seed(self, i: int) -> int:
        return 0 if self.noise is None else mix(self.seed, i, 1)

    def call(self, i: int):
        return self.snn_mod.forward_silicon(
            self.params, self.events(i), self.cfg, seed=self.call_seed(i),
            noise=self.noise, fused="seq", device=self.dev)

    def keep(self, i: int, out) -> None:
        """A reservoir of ``RESERVOIR`` passes drawn from the seed, and
        the last pass."""
        self.outputs["last"] = (i, out)
        if i < RESERVOIR:
            self.outputs[i] = (i, out)
        else:
            j = self._pick.randrange(i + 1)
            if j < RESERVOIR:
                self.outputs[j] = (i, out)

    def telemetry(self) -> dict:
        return self.outputs["last"][1][1]

    def work(self) -> dict:
        return counts.macro_work(self.config["snn"], self.units,
                                 self.noise is not None, train=False)

    def kept(self) -> list:
        """The kept passes, (call index, (logits, telemetry)), each once."""
        return sorted(dict(self.outputs.values()).items())

    def reference(self, i: int, tf32: bool = False) -> tuple:
        """The reference's (logits, telemetry) of the window's i-th call."""
        return ref.forward(self.raw, self.events(i), self.config["snn"],
                           self.call_seed(i),
                           weights.reference_noise(self.traffic), tf32)

    @staticmethod
    def _gap(got: tuple, want: tuple) -> float:
        (logits, tele), (r_logits, r_tele) = got, want
        return check.widest_gap([(logits, r_logits)] + [
            (tele[k], r_tele[k]) for k in r_tele])

    def numbers(self) -> dict:
        return {"output_gap": max(self._gap(out, self.reference(i))
                                  for i, out in self.kept())}

    def control_numbers(self) -> dict:
        return {"output_gap": max(
            self._gap(self.reference(i, tf32=True), self.reference(i))
            for i, _ in self.kept())}
