"""The dry run of every cell on both fake production meshes, for one or
more source trees side by side, and the table of a rank's counts.

    python3 scripts/dryrun_cells.py --trees PARENT CHANGE \
        [--mesh single|multi|both] [--cells all|ARCH:SHAPE,...] \
        [--jobs 8] [--timeout 1800] [--out chiprun_out/dryrun_cells]

Each tree is a checkout of this repository (a ``git archive`` unpacked
under ``build/``, or ``.``).  Every (tree, cell, mesh) runs ``python -m
repro_torch.launch.dryrun --arch A --shape S --mesh M`` in a process of
its own (the dry run sets up its own fake process group), ``--jobs`` at
a time, the slowest kinds first, each cut at ``--timeout`` seconds; the
results are ``launch.dryrun``'s JSON files under ``OUT/<i>/`` (the i-th
tree).  It then prints, and writes to ``OUT/table.md``, one row a cell
and mesh: for each tree rank 0's counted FLOPs, the model's FLOPs a
device (``roofline.flops_model``), their ratio, ``bytes_per_device``
and whether it fits the card's 80 GB, the wire a rank by kind
(all-reduce, reduce-scatter, all-gather; GB), the residual stream's
positions a rank (``seq_block``) and the seconds the count took; and
the model's tensor-parallel activation wire of a train or prefill cell,
``roofline.flops_model``'s ``(2.0 if seq_sharded else 4.0) * tok * d *
BF16`` a layer (times the layers and, in a train cell, the passes).
Runs on any host; it needs no card and builds nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CARD_BYTES = 80e9
# the kinds of cell, slowest first (a train cell counts its microbatches'
# forward, recompute and backward)
ORDER = ("train_4k", "prefill_32k", "long_500k", "decode_32k")


def cells(tree: Path) -> tuple[list[tuple[str, str]], dict]:
    """The tree's runnable cells, and each architecture's fields that
    the table reads (its layer count first)."""
    code = ("import json, sys; sys.path.insert(0, 'src'); "
            "from repro_torch.configs import ARCHS, cells; "
            "print(json.dumps([cells(), "
            "{a: [c.n_layers, c.d_model, c.remat, c.remat_mode, "
            "c.remat_policy, (c.sharding_overrides or {}).get('seq')] "
            "for a, c in ARCHS.items()}]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tree,
                         capture_output=True, text=True, check=True)
    todo, fields = json.loads(out.stdout)
    return [tuple(c) for c in todo], fields


SHAPES = {"train_4k": (4096, 256), "prefill_32k": (32768, 32)}
BF16 = 2


def tp_act_wire(fields: list, shape: str, mesh: str) -> float | None:
    """The model's tensor-parallel activation wire a device of a train
    or prefill cell (``roofline.flops_model``: a layer's ``(2.0 if
    seq_sharded else 4.0) * tok * d * BF16``, over a device row's
    tokens, times the layers, and in a train cell the passes the remat
    runs: 3 under "nothing", 2 under "dots" / "attn_only" or without
    remat)."""
    if shape not in SHAPES:
        return None
    n_layers, d, remat, mode, policy, seq = fields
    s, b = SHAPES[shape]
    tok_row = b * s / (16 if mesh == "single" else 32)
    per_layer = (2.0 if seq == "model" else 4.0) * tok_row * d * BF16
    if shape == "prefill_32k":
        return per_layer * n_layers
    passes = 2.0 if (not remat or mode == "attn_only"
                     or policy == "dots") else 3.0
    return per_layer * n_layers * passes


def run_one(tree: Path, out: Path, arch: str, shape: str, mesh: str,
            timeout: float) -> dict:
    tag = f"{arch}__{shape}__{mesh}"
    path = out / f"{tag}.json"
    if path.exists():
        return {"tag": tag, "status": "cached"}
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    t0 = time.perf_counter()
    try:
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out", str(out)],
            cwd=tree, env=env, capture_output=True, text=True,
            timeout=timeout)
        status = "ok" if r.returncode == 0 else f"exit {r.returncode}"
        err = r.stdout[-2000:] + r.stderr[-2000:] if r.returncode else ""
    except subprocess.TimeoutExpired:
        status, err = "timeout", ""
    sec = time.perf_counter() - t0
    print(f"[{out.name}] {tag}: {status} in {sec:.1f} s", flush=True)
    if err:
        print(err, flush=True)
    return {"tag": tag, "status": status, "seconds": sec}


def _fmt(x, spec=".4g") -> str:
    return "—" if x is None else format(x, spec)


WIRE = ("all-reduce", "reduce-scatter", "all-gather")


def table(trees: list[Path], out: Path, todo, fields: dict) -> str:
    head = "| cell | mesh |"
    for i, _ in enumerate(trees):
        head += (f" FLOPs a rank [{i}] | x model [{i}] | GB a rank [{i}] |"
                 f" fits 80 GB [{i}] |"
                 + "".join(f" {k} GB [{i}] |" for k in WIRE)
                 + f" positions a rank [{i}] | s [{i}] |")
    head += " model FLOPs a device | model TP activation wire GB |"
    cols = 8 + len(WIRE)
    lines = [head, "|" + "---|" * (4 + cols * len(trees))]
    for arch, shape, mesh in todo:
        row = f"| {arch} x {shape} | {'16x16' if mesh == 'single' else '2x16x16'} |"
        model = None
        for i, _ in enumerate(trees):
            path = out / str(i) / f"{arch}__{shape}__{mesh}.json"
            if not path.exists():
                row += " not counted |" + " — |" * (cols - 1)
                continue
            r = json.loads(path.read_text())
            model = r["roofline"]["flops_per_device"]
            flops, nbytes = r.get("flops"), r.get("bytes_per_device")
            wire = r.get("collectives_counted", {})
            row += (f" {_fmt(flops, '.6g')} | {_fmt(flops / model, '.4g')} |"
                    f" {_fmt(nbytes / 1e9, '.4g')} |"
                    f" {'yes' if nbytes <= CARD_BYTES else 'no'} |"
                    + "".join(f" {_fmt(wire.get(k + '_bytes', 0) / 1e9, '.5g')} |"
                              for k in WIRE)
                    + f" {r.get('seq_block', '—')} |"
                    f" {_fmt(r.get('wall_s'), '.1f')} |")
        act = tp_act_wire(fields[arch], shape, mesh)
        lines.append(row + f" {_fmt(model, '.6g')} |"
                     f" {_fmt(act and act / 1e9, '.5g')} |")
    return "\n".join(lines) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--cells", default="all")
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--timeout", type=float, default=1800.0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "dryrun_cells"))
    args = ap.parse_args(argv)
    trees = [Path(t).resolve() for t in args.trees]
    out = Path(args.out).resolve()
    every, fields = cells(trees[-1])
    if args.cells == "all":
        want = every
    else:
        want = [tuple(c.split(":")) for c in args.cells.split(",")]
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    todo = [(a, s, m) for a, s in want for m in meshes]
    # the deepest train cells first (xLSTM's sLSTM steps through every
    # position, the slowest of all)
    jobs = sorted(((i, t, a, s, m) for a, s, m in todo
                   for i, t in enumerate(trees)),
                  key=lambda j: (ORDER.index(j[3]),
                                 -fields[j[2]][0] * (10 if "xlstm" in j[2]
                                                     else 1), j[4], j[0]))
    for i, _ in enumerate(trees):
        (out / str(i)).mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(args.jobs) as pool:
        runs = list(pool.map(
            lambda j: run_one(j[1], out / str(j[0]), j[2], j[3], j[4],
                              args.timeout), jobs))
    text = table(trees, out, todo, fields)
    (out / "table.md").write_text(text)
    (out / "runs.json").write_text(json.dumps(runs, indent=1))
    print(text)
    bad = [r for r in runs if r["status"] not in ("ok", "cached")]
    print(f"{len(runs)} runs in {time.perf_counter() - t0:.1f} s; "
          f"{len(bad)} not counted: {[(r['tag'], r['status']) for r in bad]}")


if __name__ == "__main__":
    main()
