"""Fig. 9: (a) energy breakdown per mode, (b) EE across supply voltages.
Calibrated model: ``repro_torch.core.energy``."""

from repro_torch.core import energy


def run() -> dict:
    kwn_bd = energy.kwn_step_energy(12, energy.SPIKE_RATES["dvs_gesture"])
    nld_bd = energy.nld_step_energy(energy.SPIKE_RATES["dvs_gesture"], "relu")
    return {
        "breakdown_kwn_dvs": kwn_bd.as_dict(),
        "breakdown_nld_dvs": nld_bd.as_dict(),
        "kwn_control_power_frac": round(kwn_bd.as_dict()["frac"]["control"], 3),
        "paper_control_frac": 0.168,
        "ee_vs_vdd": energy.ee_vs_vdd(),
        "table1": energy.table1_energy_entries(),
        "improvement_vs_sota_1p3": round(energy.improvement_vs_sota(), 3),
    }
