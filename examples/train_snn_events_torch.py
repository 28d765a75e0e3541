"""Train the paper's SNN on the synthetic N-MNIST stand-in and evaluate both
silicon modes on the port (the paper's Fig. 8 experiment, reduced).

The counterpart of ``examples/train_snn_events.py`` on ``repro_torch``,
with its flags.  Clean and noisy evaluation run through the fused macro
kernels (one launch per event sequence; the Fig. 7 error model's draws
come from the in-kernel counter PRNG).  The KWN cell then runs
``--silicon-steps`` noise-aware fine-tuning steps *through* the fused
kernel (forward: the serving kernel under the Fig. 7 error model with a
fresh counter seed per step; backward: the surrogate backward kernel) and
prints the clean and noisy accuracy before and after.  The serving engine
drains the same requests clean and noisy.  ``--stack W1,W2[,...]`` adds a
stacked-KWN cell: every layer in one launch of the stacked kernel.

Runs on the card by default; ``--device cpu`` runs the plain versions.

    python examples/train_snn_events_torch.py [--steps 150]
        [--silicon-steps 60] [--stack 96,64] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch import device as device_lib  # noqa: E402
from repro_torch.core import ima  # noqa: E402
from repro_torch.data import events as ev_lib  # noqa: E402
from repro_torch.models import snn  # noqa: E402
from repro_torch.serve.engine import EventRequest, SNNEventEngine  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--silicon-steps", type=int, default=60,
                    help="noise-aware QAT fine-tune steps through the fused "
                         "kernel (KWN mode; 0 disables the stage)")
    ap.add_argument("--silicon-lr", type=float, default=0.02)
    ap.add_argument("--dataset", default="nmnist",
                    choices=list(ev_lib.DATASETS))
    ap.add_argument("--serve-requests", type=int, default=96,
                    help="event streams pushed through the serving engine")
    ap.add_argument("--stack", default="",
                    help="comma-separated hidden widths for an extra "
                         "stacked-KWN cell (e.g. 96,64); every layer runs "
                         "in one launch of the stacked kernel")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    dev = device_lib.resolve(args.device)
    dcfg = ev_lib.DATASETS[args.dataset]
    ds = ev_lib.EventDataset(dcfg, device=dev)
    noise_model = ima.IMANoiseModel()
    k_top = 12 if args.dataset == "dvs_gesture" else 3

    def evaluate(p, cfg, noise=None):
        return snn.evaluate(p, cfg, ds, torch.Generator(dev).manual_seed(1),
                            n_batches=4, noise=noise, fused=True,
                            device=dev)

    def serve(p, cfg, tag, noise=None):
        gen = torch.Generator(dev).manual_seed(7)
        ev, lab = ds.sample(gen, args.serve_requests)
        engine = SNNEventEngine(cfg, p, batch_slots=32, noise=noise,
                                device=dev)
        for i in range(args.serve_requests):
            engine.submit(EventRequest(uid=i, events=ev[i].cpu().numpy(),
                                       label=int(lab[i])))
        done = engine.run()
        hits = sum(r.pred == r.label for r in done)
        rep = engine.energy_report(args.dataset)
        saving = (f"  measured ADC saving {rep['measured_adc_saving']:.2f}"
                  if "measured_adc_saving" in rep else "")
        print(f"  serve[{tag}]: {len(done)} requests  "
              f"acc {hits / len(done):.3f}{saving}  "
              f"{rep.get('pj_per_sop', float('nan')):.2f} pJ/SOP")

    for mode in ("kwn", "nld"):
        cfg = snn.SNNConfig(n_in=dcfg.n_in, n_steps=dcfg.n_steps,
                            n_classes=dcfg.n_classes, mode=mode, k=k_top)
        p, losses = snn.train(cfg, ds, n_steps=args.steps, batch=64,
                              device=dev)
        acc_n, _ = evaluate(p, cfg, noise_model)
        acc_f, tele_f = evaluate(p, cfg)
        print(f"{args.dataset} {mode.upper():3s}: loss "
              f"{losses[0]:.2f}->{losses[-1]:.2f}  "
              f"fused acc {acc_f:.3f}  noisy fused acc {acc_n:.3f}  "
              f"mean ADC steps {tele_f['adc_steps']:.1f}/31  "
              f"LIF updates/step {tele_f['lif_updates']:.0f}/128",
              flush=True)

        if mode == "kwn" and args.silicon_steps:
            # fine-tune against the fused kernel under the Fig. 7 error
            # model (a fresh counter seed per step)
            p_ft, ft_losses = snn.train(
                cfg, ds, n_steps=args.silicon_steps, batch=64,
                lr=args.silicon_lr, seed=5, silicon=True,
                noise=noise_model, params=p, device=dev)
            ft_clean, _ = evaluate(p_ft, cfg)
            ft_noisy, _ = evaluate(p_ft, cfg, noise_model)
            print(f"  silicon fine-tune ({args.silicon_steps} steps, "
                  f"noise-aware QAT): loss "
                  f"{ft_losses[0]:.3f}->{ft_losses[-1]:.3f}  "
                  f"clean {acc_f:.3f}->{ft_clean:.3f}  "
                  f"noisy {acc_n:.3f}->{ft_noisy:.3f}  "
                  f"(gap {acc_f - acc_n:+.3f} -> "
                  f"{ft_clean - ft_noisy:+.3f})", flush=True)
            p = p_ft   # serve the silicon-tuned model below

        if mode == "kwn" and args.serve_requests:
            for tag, noise in (("clean", None), ("noisy", noise_model)):
                serve(p, cfg, tag, noise)

    if args.stack:
        widths = tuple(int(w) for w in args.stack.split(","))
        cfg = snn.SNNConfig(n_in=dcfg.n_in, n_steps=dcfg.n_steps,
                            n_classes=dcfg.n_classes, mode="kwn",
                            hidden_layers=widths,
                            k_layers=(k_top,) * len(widths))
        p, losses = snn.train(cfg, ds, n_steps=args.steps, batch=64,
                              device=dev)
        acc_f, tele_f = evaluate(p, cfg)
        acc_n, _ = evaluate(p, cfg, noise_model)
        layers = "x".join(str(w) for w in widths)
        print(f"{args.dataset} KWN stack {layers} (one fused launch, "
              f"{len(widths)} layers): loss "
              f"{losses[0]:.2f}->{losses[-1]:.2f}  "
              f"fused acc {acc_f:.3f}  noisy fused acc {acc_n:.3f}  "
              f"skipped blocks {tele_f['skipped_block_ratio']:.2f}",
              flush=True)
        if args.serve_requests:
            serve(p, cfg, "stack")


if __name__ == "__main__":
    main()
