"""The kinds of runner, one module each, found by name: a traffic file's
``runner`` is the module ``runners/<runner>.py``.

A kind's module defines

* ``Runner(config, traffic, seed, dev)``: makes its inputs and weights
  on ``dev`` from ``seed``, warms up every shape its window uses, and
  then serves ``call(i)`` for the window's i-th call and ``keep(i, out)``
  after it has synchronised.  It has ``phase`` (the phase its metrics
  read, such as ``"eval"``), ``units`` (the work one call completes),
  ``telemetry()`` (the program's counters of the last call), ``work()``
  (the call's operations and bytes from shapes alone, or None),
  ``numbers()`` (the numbers compared with the reference, for
  ``correct``) and ``control_numbers()`` (the same numbers of the
  control: the reference in the program's place at a lower precision);
* ``FAULTS``: name -> a function giving the context in which that fault
  lies under the timed path.

Adding a kind adds a module here; no other file changes.
"""

from __future__ import annotations

import importlib
import random

import torch


def load(kind: str):
    """The module of runner kind ``kind``."""
    return importlib.import_module(f"{__name__}.{kind}")


def mix(seed: int, index: int, tag: int) -> int:
    """A 31-bit word from (seed, index, tag): the seed of a call or step,
    the same on every run of one ``--seed``."""
    return random.Random(f"{seed}:{index}:{tag}").getrandbits(31)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
