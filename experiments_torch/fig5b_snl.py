"""Fig. 5b: SNL + PRBS noise accuracy improvement in KWN mode.
Paper: +0.5-0.6 % on both datasets.

Runs the composed chain, as the JAX script does, with SNL on and off
(``use_snl``), and the fused KWN kernel (#1) beside it; clean results
equal the JAX script's bit for bit on the same batches (``_snn_cache``)."""

from experiments_torch import _snn_cache as C


def run() -> dict:
    out = {}
    for ds_name in ("nmnist", "dvs_gesture"):
        p, cfg, ds = C.trained_model(ds_name, "kwn", train_nlq=True)
        acc_snl, _ = C.eval_model(p, cfg, ds, use_snl=True)
        acc_no, _ = C.eval_model(p, cfg, ds, use_snl=False)
        out[ds_name] = {
            "kwn_with_snl": round(acc_snl, 4),
            "kwn_without_snl": round(acc_no, 4),
            "snl_gain_pct": round((acc_snl - acc_no) * 100, 2),
        }
    out["paper_claim_pct"] = "0.5-0.6"
    return out
