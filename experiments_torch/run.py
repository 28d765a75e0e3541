"""Experiment harness: one module per paper table / figure, on the port.

    PYTHONPATH=src python -m experiments_torch.run [--only fig8_accuracy] [--device cpu]

Prints ``name,us_per_call,derived`` CSV (derived = compact JSON of the
reproduced numbers) and a human-readable block per experiment, and writes
``experiments_torch/.cache/results/<name>.json`` and ``_summary.json``
(each experiment's wall seconds, the launches of each fused kernel it
made, its evaluations with the composed chain's and the kernel path's
accuracies, and the device).  Without ``--device cpu`` it runs on the card and
raises where there is none.  ``$REPRO_SNN_TRAIN_STEPS``,
``$REPRO_SNN_EVAL_BATCHES`` and ``$REPRO_LM_ABLATION_STEPS`` cut the
depth (the reference's 350, 6 and 40 by default).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from experiments_torch import (_snn_cache, ablation_k_sweep,
                               ablation_kwn_lm, fig3d_weight_impl,
                               fig5b_snl, fig6c_nlq, fig7_ima, fig8_accuracy,
                               fig9_energy, latency_kwn, table1_comparison)
from repro_torch.kernels import fused_macro

BENCHES = {
    "fig3d_weight_impl": fig3d_weight_impl,
    "fig7_ima": fig7_ima,
    "fig9_energy": fig9_energy,
    "latency_kwn": latency_kwn,
    "fig5b_snl": fig5b_snl,
    "fig6c_nlq": fig6c_nlq,
    "fig8_accuracy": fig8_accuracy,
    "table1_comparison": table1_comparison,
    "ablation_kwn_lm": ablation_kwn_lm,
    "ablation_k_sweep": ablation_k_sweep,
}
COUNTED = {"fused_macro_seq_kwn": fused_macro.fused_macro_seq,
           "fused_macro_seq_nld": fused_macro.fused_macro_seq_nld}


def recorded(eval_model, evals: list):
    """``eval_model`` that also appends each call's accuracies, the
    composed chain's and the kernel path's (its ``kernel_acc``), to
    ``evals``."""
    def record(p, cfg, ds, seed=1, **kw):
        acc, tele = eval_model(p, cfg, ds, seed, **kw)
        evals.append({"dataset": ds.cfg.name, "mode": cfg.mode,
                      "k": kw.get("k") or cfg.k,
                      "noise": kw.get("noise") is not None,
                      "use_snl": kw.get("use_snl", cfg.use_snl),
                      "train_nlq": cfg.train_nlq, "acc": acc,
                      "kernel_acc": tele.get("kernel_acc")})
        return acc, tele
    return record


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None, choices=sorted(BENCHES))
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain versions; default the card")
    args = ap.parse_args(argv)
    _snn_cache.DEVICE = args.device
    dev = _snn_cache.device()

    names = [args.only] if args.only else list(BENCHES)
    results_dir = os.path.join(_snn_cache.CACHE_DIR, "results")
    os.makedirs(results_dir, exist_ok=True)
    print("name,us_per_call,derived")
    summary = {"device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu"),
               "train_steps": _snn_cache.TRAIN_STEPS,
               "eval_batches": _snn_cache.EVAL_BATCHES,
               "lm_steps": ablation_kwn_lm.STEPS, "runs": {}}
    failures = 0
    for name in names:
        mod = BENCHES[name]
        for fn in COUNTED.values():
            fn.launches = 0
        evals: list[dict] = []
        inner = _snn_cache.eval_model
        _snn_cache.eval_model = recorded(inner, evals)
        t0 = time.time()
        try:
            derived = mod.run()
            secs = time.time() - t0
            with open(os.path.join(results_dir, f"{name}.json"), "w") as f:
                json.dump(derived, f, indent=1, default=str)
            summary["runs"][name] = {
                "seconds": secs,
                "launches": {k: fn.launches for k, fn in COUNTED.items()},
                "evals": evals}
            compact = json.dumps(derived, separators=(",", ":"),
                                 default=str)
            print(f"{name},{secs * 1e6:.0f},{compact}")
            print(f"--- {name} ---", file=sys.stderr)
            print(json.dumps(derived, indent=1, default=str)[:4000],
                  file=sys.stderr)
        except Exception as e:  # pragma: no cover
            failures += 1
            summary["runs"][name] = {"error": repr(e)}
            print(f"{name},FAILED,{e!r}")
        finally:
            _snn_cache.eval_model = inner
        sys.stdout.flush()
    summary["seconds"] = sum(r.get("seconds", 0.0)
                             for r in summary["runs"].values())
    with open(os.path.join(results_dir, "_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    if failures:
        raise SystemExit(1)
    return summary


if __name__ == "__main__":
    main()
