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
and whether it fits the card's 80 GB, and the seconds the count took.
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
    """The tree's runnable cells, and each architecture's layer count."""
    code = ("import json, sys; sys.path.insert(0, 'src'); "
            "from repro_torch.configs import ARCHS, cells; "
            "print(json.dumps([cells(), "
            "{a: c.n_layers for a, c in ARCHS.items()}]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tree,
                         capture_output=True, text=True, check=True)
    todo, layers = json.loads(out.stdout)
    return [tuple(c) for c in todo], layers


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


def table(trees: list[Path], out: Path, todo) -> str:
    head = "| cell | mesh |"
    for i, _ in enumerate(trees):
        head += (f" FLOPs a rank [{i}] | x model [{i}] | GB a rank [{i}] |"
                 f" fits 80 GB [{i}] | s [{i}] |")
    head += " model FLOPs a device |"
    lines = [head, "|" + "---|" * (3 + 5 * len(trees))]
    for arch, shape, mesh in todo:
        row = f"| {arch} x {shape} | {'16x16' if mesh == 'single' else '2x16x16'} |"
        model = None
        for i, _ in enumerate(trees):
            path = out / str(i) / f"{arch}__{shape}__{mesh}.json"
            if not path.exists():
                row += " not counted | — | — | — | — |"
                continue
            r = json.loads(path.read_text())
            model = r["roofline"]["flops_per_device"]
            flops, nbytes = r.get("flops"), r.get("bytes_per_device")
            row += (f" {_fmt(flops, '.6g')} | {_fmt(flops / model, '.4g')} |"
                    f" {_fmt(nbytes / 1e9, '.4g')} |"
                    f" {'yes' if nbytes <= CARD_BYTES else 'no'} |"
                    f" {_fmt(r.get('wall_s'), '.1f')} |")
        lines.append(row + f" {_fmt(model, '.6g')} |")
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
    every, layers = cells(trees[-1])
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
                                 -layers[j[2]] * (10 if "xlstm" in j[2]
                                                  else 1), j[4], j[0]))
    for i, _ in enumerate(trees):
        (out / str(i)).mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(args.jobs) as pool:
        runs = list(pool.map(
            lambda j: run_one(j[1], out / str(j[0]), j[2], j[3], j[4],
                              args.timeout), jobs))
    text = table(trees, out, todo)
    (out / "table.md").write_text(text)
    (out / "runs.json").write_text(json.dumps(runs, indent=1))
    print(text)
    bad = [r for r in runs if r["status"] not in ("ok", "cached")]
    print(f"{len(runs)} runs in {time.perf_counter() - t0:.1f} s; "
          f"{len(bad)} not counted: {[(r['tag'], r['status']) for r in bad]}")


if __name__ == "__main__":
    main()
