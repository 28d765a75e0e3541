"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``configs/<config>.json`` (the manifest's ``file``), a
traffic mix ``traffic/<traffic>.json``, a metric's reader
``metrics/<metric>.py`` (a ``read(ctx)`` that returns a number, or None
where it finds nothing to read), and a cell's limits of correctness
``limits/<workload>.json``; a traffic file's ``runner`` is the module
``runners/<runner>.py`` (``runners.load``).  Adding a cell, a metric or a
kind of runner adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(manifest: dict, name: str) -> dict:
    return _named(manifest["workloads"], name, "workload")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    entry = _named(manifest["configs"], name, "config")
    return json.loads((root / entry["file"]).read_text())


def traffic(name: str, bench: Path = BENCH) -> dict:
    return json.loads((bench / "traffic" / f"{name}.json").read_text())


def metrics(manifest: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the per-layer ones when
    traced, else the end-to-end ones; each where its ``workloads`` lists
    the cell, or everywhere without the key."""
    group = manifest["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str, bench: Path = BENCH):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"cimbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
