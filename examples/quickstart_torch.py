"""Quickstart: run the NeuDW-CIM macro in both modes on one event batch,
on the port.

    python examples/quickstart_torch.py [--device cpu]

The counterpart of ``examples/quickstart.py`` over ``repro_torch.core``:
ternary events -> twin-cell MAC -> (KWN: NLQ ramp + top-K early stop +
sparse LIF with SNL) vs (NLD: dendritic branch MACs through the
NL-activation ramp + dense LIF).  Each mode runs twice: the composed
stage functions, then the same batch as an 8-step sequence through the
fused kernel (the seq-KWN and seq-NLD kernels on the card), whose first
step's KWN winners must equal the composed ones.  Then the latency and
energy numbers the silicon measures.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch import device as device_lib  # noqa: E402
from repro_torch.core import dendrite, energy, lif, macro, ternary  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    dev = device_lib.resolve(ap.parse_args(argv).device)
    gen = torch.Generator().manual_seed(0)

    # --- a batch of ternary event vectors (ON/OFF/idle), 256 inputs --------
    events = torch.sign(torch.randn((8, 256), generator=gen))
    events = (events * (torch.rand((8, 256), generator=gen) < 0.06)).to(dev)
    print(f"input spike rate: {float(events.abs().mean()):.3f}")

    # --- twin 9T weights: 3-bit from two ternary planes ---------------------
    w_float = torch.randn((256, 128), generator=gen).to(dev)
    w_int, scale = ternary.quantize_weights_3bit(w_float)
    msb, lsb = ternary.weight_decompose(w_int)
    print(f"weights: int grid [-3,3], msb/lsb ternary planes, compose check: "
          f"{bool((ternary.weight_compose(msb, lsb) == w_int).all())}")

    # --- KWN mode: NLQ conversion + top-12 winners with early stop ----------
    cfg = macro.CIMMacroConfig(code_bits=5, mac_range=24.0)
    drive, mask, res = macro.kwn_forward(events, w_int, k=12, cfg=cfg)
    print(f"\nKWN mode: {int(mask[0].sum())} winners/128 columns, "
          f"ADC stopped after {int(res.adc_steps[0])}/31 ramp steps "
          f"({1 - float(res.adc_steps[0]) / 31:.0%} latency saved)")
    state = lif.lif_init((8, 128), device=dev)
    state, spikes = lif.lif_step(state, drive * 0.02, lif.LIFParams(),
                                 update_mask=mask)
    print(f"LIF: {int(spikes.sum())} spikes, only {int(mask[0].sum())} of "
          f"128 V_mem updates "
          f"({128 / int(mask[0].sum()):.1f}x serial-latency saving)")

    # the batch as one 8-step sequence through the fused KWN kernel
    fw = macro.pack_kwn_weights(w_int, scale, cfg)
    v0 = torch.zeros((1, 128), device=dev)
    v_out, spk, kmask, steps, _ = macro.fused_seq(
        events[:, None], fw, v0, k=12, drive_gain=0.25, use_snl=False,
        mac_telemetry=False)
    same = torch.equal(kmask[0, 0], mask[0])
    print(f"fused KWN sequence: {int(spk.sum())} spikes over 8 steps, ADC "
          f"steps {steps[:, 0].tolist()}; step 0 winners equal the "
          f"composed ones: {same}")
    if not same:
        raise SystemExit("fused KWN winners differ from the composed path")

    # --- NLD mode: nonlinear dendrites through the reconfigurable IMA -------
    dp = dendrite.dendrite_init(gen, 256, 128, n_branches=2, device=dev)
    nld_cfg = macro.CIMMacroConfig(code_bits=5, mac_range=4.0)
    nld_drive = macro.nld_forward(events, dp, nld_cfg,
                                  activation="quadratic")
    print(f"\nNLD mode: dendritic drive range [{float(nld_drive.min()):.2f}, "
          f"{float(nld_drive.max()):.2f}] via quadratic NL-IMA "
          f"(f(x)=0.5x^2)")
    fw_nld = macro.pack_nld_weights(dp, nld_cfg, activation="quadratic")
    _, spk_nld, _, _, _ = macro.fused_seq(events[:, None], fw_nld, v0,
                                          drive_gain=0.25)
    print(f"fused NLD sequence: {int(spk_nld.sum())} spikes over 8 steps, "
          f"every neuron updated every step")

    # --- the numbers the paper measures --------------------------------------
    print("\nenergy model (calibrated to silicon):")
    for k, v in energy.table1_energy_entries().items():
        print(f"  {k:28s} {v:.2f} pJ/SOP")
    print(f"  1.6x-vs-SOTA check: {energy.improvement_vs_sota():.2f}x")


if __name__ == "__main__":
    main()
