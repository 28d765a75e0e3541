"""Builds the experiments report from the port's artifacts:
``experiments_torch/.cache/results/*.json`` (``python -m
experiments_torch.run``), ``dryrun_results_torch/*.json`` (``python -m
repro_torch.launch.dryrun``) and ``perf_results_torch/*.json``
(``python -m repro_torch.launch.hillclimb``).

    PYTHONPATH=src python -m experiments_torch.make_experiments [--out PATH]

Counterpart of ``benchmarks/make_experiments.py``; it writes
``experiments_torch/.cache/EXPERIMENTS.md`` unless ``--out`` says
otherwise.  Every time in it is a model term at the H100 SXM's rates;
the card and power limit of the machine that builds it are named where
``nvidia-smi`` answers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

from experiments_torch import roofline_report
from repro_torch.roofline import analysis

HERE = os.path.dirname(__file__)
ROOT = os.path.join(HERE, "..")
RESULTS = os.path.join(HERE, ".cache", "results")
PERF = os.path.join(ROOT, "perf_results_torch")
OUT = os.path.join(HERE, ".cache", "EXPERIMENTS.md")


def _load(name, results=RESULTS):
    path = os.path.join(results, f"{name}.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


def card() -> str:
    """``name, power limit`` of this machine's card, or a note that
    there is none."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "no card on the machine that built this report"
    lines = r.stdout.strip().splitlines()
    if r.returncode or not lines:
        return "no card on the machine that built this report"
    return lines[0].strip()


def _fix_sentence(r):
    dom = r["dominant"]
    if dom == "collective":
        return ("shrink activation-collective volume (comm quantization, "
                "pipeline over the pod axis, fewer remat passes)")
    if dom == "memory":
        if "decode" in r["shape"] or "500k" in r["shape"]:
            return ("cut cache/param bytes (NLQ KV quantization, ternary "
                    "twin-cell weights, larger decode batch)")
        return "raise arithmetic intensity (bigger microbatch, fused ops)"
    return ("cut wasted flops (remat policy, causal-optimal attention "
            "kernel, capacity factor)")


def _claims(results) -> list[str]:
    md = ["## Paper claims (the port's experiments)\n",
          "| Paper claim | Paper value | Reproduced | Source |",
          "|---|---|---|---|"]
    f9 = _load("fig9_energy", results) or {}
    t1 = f9.get("table1", {})
    rows = [
        ("KWN EE, N-MNIST (K=3, 0.7V)", "0.8 pJ/SOP",
         f"{t1.get('kwn_nmnist_pj_per_sop', 0):.2f} pJ/SOP", "fig9_energy"),
        ("KWN EE, DVS Gesture (K=12)", "1.5 pJ/SOP",
         f"{t1.get('kwn_dvs_pj_per_sop', 0):.2f} pJ/SOP", "fig9_energy"),
        ("NLD EE (3 datasets)", "1.8 / 2.3 / 2.1 pJ/SOP",
         f"{t1.get('nld_nmnist_pj_per_sop', 0):.2f} / "
         f"{t1.get('nld_dvs_pj_per_sop', 0):.2f} / "
         f"{t1.get('nld_quiroga_pj_per_sop', 0):.2f}", "fig9_energy"),
        ("EE improvement vs SOTA [9]", "1.6x",
         f"{f9.get('improvement_vs_sota_1p3', 0):.2f}x", "fig9_energy"),
        ("KWN control logic power share", "16.8 %",
         f"{100 * f9.get('kwn_control_power_frac', 0):.1f} %", "fig9_energy"),
    ]
    f3 = _load("fig3d_weight_impl", results) or {}
    rows += [
        ("5-bit weight: latency vs PWM", "4x",
         f"{f3.get('latency_advantage_5b_vs_pwm', 0):.1f}x", "fig3d"),
        ("5-bit weight: cells vs MCL", "7.8x",
         f"{f3.get('cell_advantage_5b_vs_mcl', 0):.2f}x", "fig3d"),
    ]
    f7 = _load("fig7_ima", results) or {}
    rows += [
        ("NLQ transfer error mu", "0.41 LSB",
         f"{f7.get('nlq_mean_lsb', 0):.2f} LSB", "fig7"),
        ("NLQ transfer error sigma", "1.34 LSB",
         f"{f7.get('nlq_sigma_lsb', 0):.2f} LSB", "fig7"),
        ("NL-activation INL (y=0.5x^2)", "0.91 LSB",
         f"{f7.get('nl_activation_inl_lsb', 0):.2f} LSB", "fig7"),
    ]
    lat = _load("latency_kwn", results) or {}
    mdl = lat.get("model", {})
    rows += [
        ("ADC early-stop saving (K=12)", "30 %",
         f"{100 * mdl.get('adc_saving_k12', 0):.0f} % (model); "
         f"{100 * lat.get('dvs_gesture', {}).get('measured_adc_saving', 0):.0f}"
         " % (measured, synthetic)", "latency_kwn"),
        ("LIF latency reduction (K=12/128)", "10x",
         f"{mdl.get('lif_speedup_k12', 0):.1f}x (exact); measured "
         f"{lat.get('dvs_gesture', {}).get('measured_lif_speedup', 0)}x",
         "latency_kwn"),
    ]
    f8 = _load("fig8_accuracy", results) or {}
    for key, label, paper in (("nmnist", "N-MNIST", "97.2 > 96.2 %"),
                              ("dvs_gesture", "DVS Ges.", "95.5 > 93.8 %"),
                              ("quiroga", "Quiroga", "96.1 % (NLD)")):
        if not f8:
            break
        r = f8.get(key, {})
        order = ">" if r.get("nld", 0) >= r.get("kwn", 0) else "<"
        rows.append((f"Accuracy ordering NLD > KWN ({label})", paper,
                     f"{100 * r.get('nld', 0):.1f} {order} "
                     f"{100 * r.get('kwn', 0):.1f} % (synthetic)", "fig8"))
    for name, key, label, paper in (
            ("fig5b_snl", "snl_gain_pct", "SNL+noise accuracy gain",
             "+0.5-0.6 %"),
            ("fig6c_nlq", "nlq_gain_pct", "NLQ-in-training gain",
             "+0.5-0.7 %")):
        d = _load(name, results) or {}
        if d:
            rows.append((label, paper,
                         f"+{d.get('nmnist', {}).get(key, 0):.2f} % (nmnist) "
                         f"/ +{d.get('dvs_gesture', {}).get(key, 0):.2f} % "
                         "(dvs)", name))
    md += ["| " + " | ".join(str(x) for x in r) + " |" for r in rows]
    md.append("\n*Accuracy rows use the synthetic event-stream stand-ins: "
              "the mechanism deltas and orderings are the reproducible "
              "claims, not absolute accuracies.*\n")
    return md


def _dry_run(dry) -> list[str]:
    cells = roofline_report.load_cells(dry)
    rows = [roofline_report.row(c) for c in cells]
    n = len(rows)
    fits = sum(1 for r in rows if r["fits_h100_80g"])
    md = ["## Dry run\n",
          f"- **{n} cells counted** on one rank of the fake production "
          "meshes (16 x 16 = 256 ranks; 2 x 16 x 16 = 512) with tensors "
          "that hold no data (`python -m repro_torch.launch.dryrun`); the "
          "skipped cells and their reasons are "
          "`repro_torch/configs/__init__.py::SHAPE_SKIPS`.",
          f"- {fits}/{n} cells fit an H100's 80 GB a rank as the port "
          "runs them: each rank holds its blocks of the parameters, the "
          "dense leaves gathered whole for the call, the whole batch and "
          "the whole decode cache.",
          "- Counted a rank: FLOPs (`FlopCounterMode`), the bytes of the "
          "state and the peak of the live temporaries, and every "
          "collective's bytes (`collectives_counted`).\n",
          "## Roofline (per arch x shape x mesh)\n",
          "Model terms in seconds a step at the H100's rates, the dominant "
          "one bold; `useful/impl` = model FLOPs (6 N D | 2 N D) over the "
          "implemented FLOPs; counted/model = what the port's rank counted "
          "over the model's figure.\n",
          roofline_report.table_md(rows),
          "\n**What would move each dominant term down:**\n"]
    seen = set()
    for r in rows:
        key = (r["arch"], r["dominant"])
        if key in seen or r["mesh"] != "16x16":
            continue
        seen.add(key)
        md.append(f"- `{r['arch']}` x `{r['shape']}` [{r['dominant']}]: "
                  f"{_fix_sentence(r)}.")
    return md


def _ladders(perf) -> list[str]:
    md = ["\n## Perf ladders (model output, 256 devices)\n",
          "Each iteration: hypothesis -> config change -> the model's "
          "terms (and, counted, the dry run's memory a rank) -> verdict: "
          "confirmed when the dominant term drops below 0.98 of the last "
          "accepted entry's with memory under 1.5x the baseline's.\n"]
    for cell in ("kimi", "nemotron", "qwen"):
        data = _load(cell, perf)
        if not data:
            continue
        arch, shape = data[0]["arch"], data[0]["shape"]
        md.append(f"### {arch} x {shape}\n")
        md.append("| iteration | hypothesis | compute s | memory s | coll s "
                  "| dominant | roofline frac | GiB/dev | verdict |")
        md.append("|---|---|---|---|---|---|---|---|---|")
        for e in data:
            a = e["analytical"]
            mem = e.get("compiled", {}).get("mem_gib")
            md.append(
                f"| {e['name']} | {e['hypothesis'][:90]}... "
                f"| {a['compute_s']:.3f} | {a['memory_s']:.3f} "
                f"| {a['collective_s']:.3f} | {a['dominant']} "
                f"| {a['roofline_frac']:.3f} "
                f"| {'-' if mem is None else f'{mem:.1f}'} "
                f"| {e.get('verdict', 'baseline')} |")
        base = data[0]["analytical"]
        accepted = next((e for e in data if e.get("accepted_final")),
                        data[0])
        final = accepted["analytical"]
        dom = base["dominant"]
        md.append(
            f"\n**{arch}** accepted = `{accepted['name']}`: roofline "
            f"fraction {base['roofline_frac']:.3f} -> "
            f"{final['roofline_frac']:.3f}; {dom} term "
            f"{base[dom + '_s']:.3f} s -> {final[dom + '_s']:.3f} s.\n")
    return md


def build(results: str = RESULTS, dry: str = roofline_report.RESULTS,
          perf: str = PERF) -> str:
    md = ["# EXPERIMENTS — NeuDW-CIM, the PyTorch / CUDA port\n",
          "Target: one NVIDIA H100 SXM a rank; the model's rates are its "
          f"data sheet's at 700 W: {analysis.PEAK_FLOPS / 1e12:g} TFLOP/s "
          f"bf16 dense, {analysis.HBM_BW / 1e12:g} TB/s HBM3, "
          f"{analysis.ICI_BW / 1e9:g} GB/s NVLink 4 each way (a 16-rank "
          "model axis spans two 8-GPU NVLink domains, so collective terms "
          "that cross nodes are optimistic).  The card of the machine "
          f"that built this report: {card()}.  Roofline terms are model "
          "output, not times on a card.\n"]
    md += _claims(results)
    md += _dry_run(dry)
    md += _ladders(perf)
    return "\n".join(md) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(build())
    print("wrote", os.path.abspath(args.out))


if __name__ == "__main__":
    main()
