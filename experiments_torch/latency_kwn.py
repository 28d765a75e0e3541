"""KWN latency claims: ADC early-stop (-30 % @ K=12 on DVS Gesture) and
serial-LIF update reduction (10x @ K=12 of 128).

Reports both the calibrated model and the ramp-scan measurement on the
synthetic event streams (the early-stop steps of the composed chain,
which kernel #1 reports equal)."""

from experiments_torch import _snn_cache as C
from repro_torch.core import energy


def run() -> dict:
    out = {"model": {
        "adc_saving_k3": round(energy.early_stop_saving(3), 3),
        "adc_saving_k12": round(energy.early_stop_saving(12), 3),  # paper 0.30
        "lif_speedup_k12": round(energy.lif_latency_speedup(12), 2),  # ~10x
        "lif_speedup_k3": round(energy.lif_latency_speedup(3), 2),
    }}
    # measured on synthetic streams through the trained model
    for ds_name in ("nmnist", "dvs_gesture"):
        p, cfg, ds = C.trained_model(ds_name, "kwn")
        _, tele = C.eval_model(p, cfg, ds)
        full = 2 ** cfg.code_bits - 1
        out[ds_name] = {
            "k": cfg.k,
            "measured_mean_adc_steps": round(tele["adc_steps"], 2),
            "full_ramp_steps": full,
            "measured_adc_saving": round(1 - tele["adc_steps"] / full, 3),
            "measured_lif_updates_per_step": tele["lif_updates"],
            "lif_updates_dense": 128,
            "measured_lif_speedup": round(128 / tele["lif_updates"], 1),
        }
    out["paper"] = {"adc_saving": 0.30, "lif_speedup": "10x"}
    return out
