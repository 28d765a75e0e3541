"""What decides ``correct``: the numbers a runner kind reads from the
outputs of the timed path against the plain reference (its
``numbers()``, ``runners/<kind>.py``), each beside the cell's limit of it
(``limits/<cell>.json``), and the two measures the kinds build their
numbers from."""

from __future__ import annotations

import json
import statistics
from pathlib import Path

from cimbench.reference import macro as ref

LIMITS = Path(__file__).resolve().parent / "limits"


def limits(workload: str, folder: Path = LIMITS) -> dict:
    """The limits of ``workload``'s numbers (``limits/<name>.json``)."""
    return json.loads((folder / f"{workload}.json").read_text())["limits"]


def widest_gap(pairs) -> float:
    """Over (got, want) pairs of tensors: the largest absolute difference
    over the largest absolute reference value (1 where that is 0)."""
    gap = 0.0
    for got, want in pairs:
        scale = float(want.abs().max()) or 1.0
        gap = max(gap, float((got.float() - want).abs().max()) / scale)
    return gap


def worst_leaf(got: dict, want: dict) -> float:
    """The worst leaf of |program norm - reference norm| over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    norms = {k: ref.leaf_norm(want[k]) for k in want}
    floor = statistics.median(norms.values())
    return max(abs(ref.leaf_norm(got[k]) - norms[k]) / max(norms[k], floor)
               for k in want)


def verdict(numbers: dict, limit: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}})."""
    checks = {k: {"value": v, "limit": limit[k]} for k, v in numbers.items()}
    return all(v <= limit[k] for k, v in numbers.items()), checks
