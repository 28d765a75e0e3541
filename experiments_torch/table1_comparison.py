"""Table I: this work's column vs the published SOTA rows: energy
efficiency (calibrated model), accuracy (synthetic stand-ins, through the
composed chain as ``fig8_accuracy``), macro parameters, plus the 1.6x EE
improvement claim."""

from experiments_torch import fig8_accuracy
from repro_torch.core import energy

SOTA = {
    "ESSERC25_[2]": {"tech_nm": 65, "ee_pj_sop": None, "dvs_acc": 0.9354},
    "ISSCC23_[1]": {"tech_nm": 28, "ee_pj_sop": 1.5, "nmnist_acc": 0.96,
                    "dvs_acc": 0.92},
    "ISSCC24_[4]": {"tech_nm": 22, "ee_pj_sop": 3.78, "nmnist_acc": 0.97,
                    "dvs_acc": 0.94},
    "VLSI25_[9]": {"tech_nm": 130, "ee_pj_sop": 1.3, "nmnist_acc": 0.971,
                   "dvs_acc": 0.9012},
}


def run() -> dict:
    ee = energy.table1_energy_entries()
    acc = fig8_accuracy.run()
    this_work = {
        "tech_nm": 65,
        "macro": "256x128",
        "weight_bits": "2-3 (twin-cell multi-VDD)",
        "vmem_bits": 12,
        "input": "binary/ternary",
        "lif": "digital (KWN sparse update)",
        "ee_kwn_nmnist_pj_sop": round(ee["kwn_nmnist_pj_per_sop"], 3),
        "ee_kwn_dvs_pj_sop": round(ee["kwn_dvs_pj_per_sop"], 3),
        "ee_nld_pj_sop": {k: round(v, 3) for k, v in ee.items()
                          if k.startswith("nld")},
        "acc_synthetic": {d: acc[d] for d in ("nmnist", "dvs_gesture",
                                              "quiroga")},
        "power_mw_modeled": {
            "kwn_dvs@468kHz": round(energy.modeled_power_mw(
                "kwn", "dvs_gesture", 468e3), 3),
            "nld_dvs@160kHz": round(energy.modeled_power_mw(
                "nld", "dvs_gesture", 160e3), 3),
        },
    }
    return {
        "this_work": this_work,
        "sota": SOTA,
        "ee_improvement_vs_vlsi25": round(energy.improvement_vs_sota(1.3), 3),
        "paper_claim": "1.6x over 1.3 pJ/SOP [9]",
    }
