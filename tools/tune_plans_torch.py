"""Tune the port's tile plans into its plan cache.

The counterpart of ``tools/tune_plans.py`` on ``repro_torch.tune``:
autotune the canonical cells (or one cell given explicitly) on a device
and persist the winners where ``repro_torch.kernels.fused_macro.plan_tiles``
finds them: ``PLAN_CACHE_fused_macro_torch.json`` at the repo root, or
``$REPRO_TORCH_PLAN_CACHE_PATH``, or ``--out``.  Entries are keyed on the
device's name, so other devices' entries survive (``--no-merge`` starts
afresh).  The repo commits no cache.

Usage:
  python tools/tune_plans_torch.py                       # the card
  python tools/tune_plans_torch.py --objective pj_per_sop
  python tools/tune_plans_torch.py \\
      --cell 128x256x128x128x32 --density 0.05            # one cell
  python tools/tune_plans_torch.py --smoke --out PATH     # tune-smoke
  PYTHONPATH=src python tools/tune_plans_torch.py --smoke --device cpu \\
      --out PATH
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def parse_cell(shape: str, density: float, mode: str, k: int):
    from repro_torch.tune import autotune
    dims = [int(d) for d in shape.split("x")]
    if len(dims) != 5:
        raise SystemExit(f"--cell wants MxKxNCxNxT, got {shape!r}")
    return autotune.TuneCell(*dims, density=density, mode=mode, k=k)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--objective", default="ms",
                    choices=("ms", "pj_per_sop", "blend"),
                    help="what the winner minimizes: median latency, the "
                         "modeled kernel-energy proxy, or a geometric blend")
    ap.add_argument("--blend-weight", type=float, default=0.5,
                    help="blend objective: weight on pJ/SOP (0 = pure ms)")
    ap.add_argument("--iters", type=int, default=9,
                    help="timed calls per candidate (median taken)")
    ap.add_argument("--patience", type=int, default=None,
                    help="stop a cell after this many consecutive "
                         "non-improving candidates (default: measure all)")
    ap.add_argument("--cell", default=None, metavar="MxKxNCxNxT",
                    help="tune one launch shape instead of the canonical set")
    ap.add_argument("--density", type=float, default=0.05,
                    help="event density for --cell (default 0.05)")
    ap.add_argument("--mode", default="kwn", choices=("kwn",),
                    help="macro mode for --cell")
    ap.add_argument("--k", type=int, default=None,
                    help="KWN winner count for --cell (default: bench K)")
    ap.add_argument("--out", default=None,
                    help="cache file to write (default: repo-root "
                         "PLAN_CACHE_fused_macro_torch.json, or "
                         "$REPRO_TORCH_PLAN_CACHE_PATH)")
    ap.add_argument("--no-merge", action="store_true",
                    help="drop existing cache entries instead of merging")
    ap.add_argument("--smoke", action="store_true",
                    help="one tiny cell, 2 timed iters, then assert the "
                         "written cache round-trips to a lookup hit that "
                         "plan_tiles consumes")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain version)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export a Perfetto trace of the tuning run (one "
                         "span per candidate measurement)")
    args = ap.parse_args(argv)

    if args.trace_out:
        from repro_torch.obs import trace as obs_trace
        obs_trace.set_tracer(obs_trace.Tracer(enabled=True))

    from repro_torch import device as device_lib
    from repro_torch.tune import autotune, cache

    dev = device_lib.resolve(args.device)
    if args.smoke:
        cells = (autotune.TuneCell(16, 128, 128, 128, 4, 0.05),)
        entries, path = autotune.tune(
            cells, objective=args.objective, iters=2, path=args.out,
            merge=not args.no_merge, device=dev)
        cache.clear_memo()
        cell = cells[0]
        hit = cache.lookup(cell.m, cell.k_dim, cell.nc, cell.n, cell.t,
                           mode=cell.mode, density=cell.density,
                           device=dev, path=path)
        assert hit is not None, "smoke: written cache did not round-trip"
        from repro_torch.kernels import fused_macro
        os.environ[cache.ENV_PATH] = path
        cache.clear_memo()
        plan = fused_macro.plan_tiles(cell.m, cell.k_dim, cell.nc, cell.n,
                                      cell.t, mode=cell.mode, device=dev)
        assert (plan.bm, plan.bk, plan.bn) == tuple(hit), \
            f"smoke: plan_tiles {plan[:3]} != cached {tuple(hit)}"
        print(f"tune-smoke OK on {cache.device_kind(dev)}: {len(entries)} "
              f"entries, round-trip hit {tuple(hit)} @ {path}")
        _export_trace(args.trace_out)
        return 0

    if args.cell:
        k = args.k if args.k is not None else autotune.K_WIN
        cells = (parse_cell(args.cell, args.density, args.mode, k),)
    else:
        cells = autotune.CANONICAL_CELLS
    autotune.tune(cells, objective=args.objective,
                  blend_weight=args.blend_weight, iters=args.iters,
                  patience=args.patience, path=args.out,
                  merge=not args.no_merge, device=dev)
    _export_trace(args.trace_out)
    return 0


def _export_trace(path: str | None) -> None:
    if not path:
        return
    from repro_torch.obs import trace as obs_trace
    n = obs_trace.get_tracer().export(path)
    print(f"wrote {n} spans to {path}")


if __name__ == "__main__":
    sys.exit(main())
