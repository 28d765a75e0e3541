"""Beyond-paper K-sweep: the KWN winner count K trades accuracy against
ADC/LIF latency and energy (the paper reports K=3 and K=12 points; this
sweeps the whole curve on the synthetic stand-ins with the cached trained
models, through the composed chain at each K, with the fused KWN kernel
#1 beside it in ``_snn_cache.eval_model``).

For each K: silicon accuracy, measured early-stop ADC steps, LIF updates,
and the calibrated pJ/SOP: the full efficiency/accuracy frontier of Eq. (1).
"""

from __future__ import annotations

from experiments_torch import _snn_cache as C
from repro_torch.core import energy

KS = (1, 3, 6, 12, 24, 48)


def run() -> dict:
    out = {}
    for ds_name in ("nmnist", "dvs_gesture"):
        p, cfg, ds = C.trained_model(ds_name, "kwn", train_nlq=True)
        rate = energy.SPIKE_RATES[ds_name]
        curve = []
        for k in KS:
            acc, tele = C.eval_model(p, cfg, ds, k=k)
            curve.append({
                "k": k,
                "acc": round(acc, 4),
                "mean_adc_steps": round(tele["adc_steps"], 2),
                "adc_saving_measured": round(1 - tele["adc_steps"] / 31, 3),
                "lif_updates": tele["lif_updates"],
                "lif_speedup": round(128 / k, 1),
                "pj_per_sop_model": round(energy.kwn_pj_per_sop(k, rate), 3),
            })
        out[ds_name] = curve
        # knee: smallest K within 1% of the best accuracy in the sweep
        best = max(c["acc"] for c in curve)
        knee = next(c for c in curve if c["acc"] >= best - 0.01)
        out[f"{ds_name}_knee"] = {"k": knee["k"], "acc": knee["acc"],
                                  "pj_per_sop": knee["pj_per_sop_model"]}
    out["note"] = ("paper operating points: K=3 (N-MNIST), K=12 (DVS "
                   "Gesture); the sweep shows where those sit on the "
                   "accuracy/energy frontier")
    return out
