"""Fig. 3d: multi-bit weight implementation cost: twin 9T multi-VDD vs
PWM vs multi-cell (MCL).  The paper claims 4x latency (vs PWM) and 7.8x
bit-cell count (vs MCL) advantages at 5 bits."""

from repro_torch.core import ternary


def run() -> dict:
    table = {}
    for bits in (2, 3, 4, 5, 6):
        row = {}
        for scheme in ("twin", "pwm", "mcl"):
            lat, cells = ternary.weight_implementation_cost(bits, scheme)
            row[scheme] = {"latency": lat, "cells": cells}
        table[f"{bits}b"] = row
    lat_adv = table["5b"]["pwm"]["latency"] / table["5b"]["twin"]["latency"]
    cell_adv = table["5b"]["mcl"]["cells"] / table["5b"]["twin"]["cells"]
    return {
        "table": table,
        "latency_advantage_5b_vs_pwm": lat_adv,          # paper: 4x
        "cell_advantage_5b_vs_mcl": round(cell_adv, 2),  # paper: 7.8x
        "matches_paper": bool(abs(lat_adv - 4.0) < 0.01
                              and abs(cell_adv - 7.75) < 0.1),
    }
