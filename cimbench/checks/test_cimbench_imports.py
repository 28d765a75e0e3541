"""Nothing the benchmark runs loads JAX or the JAX package, compared by
the whole top-level name (``repro_torch`` is the port, ``repro`` the JAX
package), and the reference loads nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from cimbench import harness, manifest

SRC = Path(__file__).resolve().parents[2] / "src"

RUN = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
import torch
from cimbench import harness, manifest
bench = manifest.load()
cell = manifest.workload(bench, {cell!r})
traffic = dict(manifest.traffic(cell["traffic"]))
traffic.update({small})
harness.execute(bench, cell, traffic, 3, 0.05, False, torch.device("cpu"),
                time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path[:0] = [{root!r}]
import cimbench.check, cimbench.events, cimbench.reference.macro
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_levels(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_repro():
    for cell, small in (("nmnist-nld.eval", {"streams": 8}),
                        ("nmnist-kwn.finetune", {"batch": 8,
                                                 "batches": 3})):
        tops = _top_levels(RUN.format(root=str(manifest.ROOT),
                                      src=str(SRC), cell=cell, small=small))
        assert "repro_torch" in tops
        assert not tops & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    tops = _top_levels(REFERENCE.format(root=str(manifest.ROOT)))
    assert not tops & (set(harness.FORBIDDEN) | {"repro_torch"})


def test_no_source_imports_jax_or_repro():
    for path in manifest.BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in harness.FORBIDDEN, path
            if path.parts[-2] == "reference" or path.name in (
                    "check.py", "events.py", "counts.py", "stats.py"):
                assert all(n.split(".")[0] != "repro_torch"
                           for n in names), path


def test_forbidden_is_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torchlike", sys)
    assert "repro_torchlike" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in harness.forbidden_modules()
