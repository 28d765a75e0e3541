"""Roofline report: the dry run's cells (``dryrun_results_torch/*.json``)
as one table per (arch x shape x mesh): the model's three terms, its
dominant bottleneck, useful / implemented FLOPs, the roofline fraction,
and beside them what the dry run counted: the port's FLOPs and wire a
device against the model's, and its memory a device against the H100's
80 GB.

Counterpart of ``benchmarks/roofline_report.py``.  Terms in seconds at
the H100 SXM's data-sheet rates (``repro_torch.roofline.analysis``).
"""

from __future__ import annotations

import glob
import json
import os

RESULTS = os.path.join(os.path.dirname(__file__), "..",
                       "dryrun_results_torch")
H100_GIB = 80 * 10 ** 9 / 2 ** 30     # 80 GB of HBM3


def load_cells(results: str = RESULTS) -> list[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(results, "*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def recompute_roofline(c: dict) -> dict:
    """The analytical terms from the current model (a cell's JSON keeps
    what was counted; the model is versioned with the code)."""
    from repro_torch.configs import get_config
    from repro_torch.roofline import flops_model
    cfg = get_config(c["arch"])
    mesh = flops_model.mesh_for(c["mesh"] != "16x16")
    return flops_model.analyze(
        cfg, c["shape"], mesh, n_micro=c.get("n_micro", 1),
        grad_bytes=2 if c.get("grad_dtype") == "bfloat16" else 4,
        moment_bytes=2 if c.get("moment_dtype") == "bfloat16" else 4)


def _ratio(a, b) -> float:
    return a / b if a and b else 0.0


def row(c: dict) -> dict:
    r = recompute_roofline(c)
    gib = c.get("bytes_per_device", 0) / 2 ** 30
    wire = c.get("collectives_counted", {}).get("total_wire_bytes", 0.0)
    return {
        "arch": c["arch"], "shape": c["shape"], "mesh": c["mesh"],
        "compute_s": r["compute_s"], "memory_s": r["memory_s"],
        "collective_s": r["collective_s"], "dominant": r["dominant"],
        "model_over_impl_flops": r["model_over_hlo"],
        "roofline_frac": r["roofline_frac"],
        "counted_over_model_flops": _ratio(c.get("flops", 0),
                                           r["flops_per_device"]),
        "counted_over_model_wire": _ratio(wire, r["wire_bytes_per_device"]),
        "mem_gib_per_dev": gib,
        "fits_h100_80g": 0 < gib <= H100_GIB,
        "count_s": c.get("count_s", 0.0),
    }


def table_md(rows: list[dict]) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | coll s | dominant "
           "| useful/impl | roofline frac | counted/model FLOPs "
           "| counted/model wire | GiB/dev | fits 80G |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compute_s']:.4f} | {r['memory_s']:.4f} "
            f"| {r['collective_s']:.4f} | **{r['dominant']}** "
            f"| {r['model_over_impl_flops']:.2f} | {r['roofline_frac']:.2f} "
            f"| {r['counted_over_model_flops']:.1f} "
            f"| {r['counted_over_model_wire']:.1f} "
            f"| {r['mem_gib_per_dev']:.1f} "
            f"| {'Y' if r['fits_h100_80g'] else 'N'} |")
    return hdr + "\n".join(lines)


def run(results: str = RESULTS) -> dict:
    rows = [row(c) for c in load_cells(results)]
    doms: dict[str, int] = {}
    for r in rows:
        doms[r["dominant"]] = doms.get(r["dominant"], 0) + 1
    single = [r for r in rows if r["mesh"] == "16x16"]
    worst = sorted(single, key=lambda r: r["roofline_frac"])[:3]
    most_coll = sorted(single, key=lambda r: -(
        r["collective_s"] / max(r["compute_s"] + r["memory_s"], 1e-12)))[:3]
    return {
        "n_cells_counted": len(rows),
        "n_fit_h100_80g": sum(r["fits_h100_80g"] for r in rows),
        "dominant_histogram": doms,
        "worst_roofline_frac": [
            {k: r[k] for k in ("arch", "shape", "roofline_frac")}
            for r in worst],
        "most_collective_bound": [
            {k: r[k] for k in ("arch", "shape", "collective_s")}
            for r in most_coll],
        "rows": rows,
    }


def write_markdown(path: str, results: str = RESULTS) -> str:
    rows = [row(c) for c in load_cells(results)]
    with open(path, "w") as f:
        f.write(table_md(rows))
    return path
