"""Fig. 8 + Table I accuracy rows: NLD vs KWN modes, 3-bit weights, 5-bit
NL-IMA, with the silicon noise model.

Paper (real datasets): N-MNIST NLD 97.2 / KWN 96.2; DVS Gesture NLD 95.5 /
KWN 93.8; Quiroga NLD 96.1.  Synthetic stand-ins: the *ordering* (NLD >
KWN) and mechanism deltas are the reproducible claims.

Both modes run through the composed chain, as the JAX script does (NLD's
branch weights in float), with the Fig. 7 noise; the fused kernels (#1
KWN, #2 NLD, the noise drawn inside them, NLD's branch weights on the
twin-cell grid) run beside it, their accuracies in the run summary's
``evals`` (``run.py``)."""

from experiments_torch import _snn_cache as C
from repro_torch.core import ima


def run() -> dict:
    noise = ima.IMANoiseModel()
    out = {}
    for ds_name in ("nmnist", "dvs_gesture", "quiroga"):
        row = {}
        p, cfg, ds = C.trained_model(ds_name, "nld")
        acc, _ = C.eval_model(p, cfg, ds, noise=noise)
        row["nld"] = round(acc, 4)
        p, cfg, ds = C.trained_model(ds_name, "kwn")
        acc, tele = C.eval_model(p, cfg, ds, noise=noise)
        row["kwn"] = round(acc, 4)
        row["kwn_k"] = cfg.k
        row["mean_adc_steps_per_conv"] = round(tele["adc_steps"], 2)
        out[ds_name] = row
    out["ordering_nld_ge_kwn"] = all(
        out[d]["nld"] >= out[d]["kwn"] - 0.02
        for d in ("nmnist", "dvs_gesture"))
    out["paper"] = {"nmnist": {"nld": 0.972, "kwn": 0.962},
                    "dvs_gesture": {"nld": 0.955, "kwn": 0.938},
                    "quiroga": {"nld": 0.961}}
    return out
