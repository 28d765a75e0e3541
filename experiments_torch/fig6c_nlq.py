"""Fig. 6c: NLQ-in-training accuracy improvement (KWN mode).
Paper: +0.5-0.7 % on two datasets when the nonlinear quantization is used
during training (vs training oblivious to the 5-bit ramp).

Evaluated clean through the composed chain, with the fused KWN kernel
(#1) beside it (``_snn_cache``)."""

from experiments_torch import _snn_cache as C


def run() -> dict:
    out = {}
    for ds_name in ("nmnist", "dvs_gesture"):
        p_nlq, cfg_nlq, ds = C.trained_model(ds_name, "kwn", train_nlq=True)
        p_raw, cfg_raw, _ = C.trained_model(ds_name, "kwn", train_nlq=False)
        acc_nlq, _ = C.eval_model(p_nlq, cfg_nlq, ds)
        acc_raw, _ = C.eval_model(p_raw, cfg_raw, ds)
        out[ds_name] = {
            "kwn_nlq_trained": round(acc_nlq, 4),
            "kwn_nlq_oblivious": round(acc_raw, 4),
            "nlq_gain_pct": round((acc_nlq - acc_raw) * 100, 2),
        }
    out["paper_claim_pct"] = "0.5-0.7"
    return out
