"""Serving driver: batched requests through the LM, optionally in CIM mode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        [--smoke] [--requests 8] [--slots 4] [--max-new 12] [--cim] \
        [--seed 0] [--device cpu]

Counterpart of ``repro.launch.serve``: a model with random weights from
``--seed`` serves batched requests through ``BatchedEngine``, optionally
with the NeuDW-CIM execution mode (ternary twin-cell weights and NLQ
activations on the FFN projections), with per-request token accounting.
Prompts (4-7 tokens) come from ``numpy.random.RandomState(seed)``.  It runs
on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.models import lm
from repro_torch.nn import module
from repro_torch.serve.engine import BatchedEngine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--cim", action="store_true",
                    help="NeuDW-CIM mode: ternary weights + NLQ activations")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = device_lib.resolve(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    if args.cim:
        cfg = dataclasses.replace(cfg, cim_linear=True)

    params = module.materialize(lm.param_specs(cfg),
                                torch.Generator().manual_seed(args.seed),
                                device=dev)
    engine = BatchedEngine(cfg, params, batch_slots=args.slots, s_max=128,
                           device=dev)

    rs = np.random.RandomState(args.seed)
    t0 = time.perf_counter()
    for uid in range(args.requests):
        prompt = [int(t) for t in rs.randint(0, cfg.vocab_size,
                                             4 + uid % 4)]
        engine.submit(Request(uid=uid, prompt=prompt,
                              max_new_tokens=args.max_new))
    done = engine.run(max_rounds=256)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.generated) for r in done)
    print(f"completed {len(done)}/{args.requests} requests, "
          f"{total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens / max(dt, 1e-9):.1f} tok/s) "
          f"cim_mode={args.cim} device={dev}")
    for r in done[:4]:
        print(f"  req {r.uid}: prompt {len(r.prompt)} toks -> {r.generated}")
    return done


if __name__ == "__main__":
    main()
