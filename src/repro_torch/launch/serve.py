"""Serving driver: batched requests through the LM, optionally in CIM mode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        [--smoke] [--requests 8] [--slots 4] [--max-new 12] [--cim] \
        [--seed 0] [--device cpu] [--layers N] [--param-dtype bfloat16]

Counterpart of ``repro.launch.serve``: a model with random weights from
``--seed`` serves batched requests through ``BatchedEngine``, optionally
with the NeuDW-CIM execution mode (ternary twin-cell weights and NLQ
activations on the FFN projections), with per-request token accounting.
``--arch`` takes every decoder configuration of the registry (all but
the encoder-only hubert-xlarge, which has no decode step: the engine
raises ``ValueError`` for it, as the reference's asserts); ``--smoke``
serves its reduced form.  internvl2-26b is served from text prompts, as
the reference's engine serves it.  The weights (f32, as the reference's,
or ``--param-dtype bfloat16``) are drawn on the run's device from a
generator seeded with ``--seed``, so a 9.4 B-parameter model is drawn in
about a second on the card.  ``--layers N`` cuts the depth to N layers
(the widths stay), for the configurations that do not fit one card whole
(kimi-k2-1t-a32b and arctic-480b).  Prompts (4-7 tokens) come from
``numpy.random.RandomState(seed)``.  It runs on ``cuda`` unless
``--device cpu`` is given.  ``main(argv, mesh=...)``, called by every
rank of a mesh (``launch.mesh``) with the same flags, serves through the
partitioned step: each rank keeps its blocks of the same drawn weights
(``nn.module.local_params``), its slots' block of the cache, and steps
them (``BatchedEngine(mesh=)``).
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


def main(argv=None, *, mesh=None):
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
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--param-dtype", default=None,
                    choices=("float32", "bfloat16"),
                    help="the weights' dtype (default: the specs', f32)")
    args = ap.parse_args(argv)

    dev = device_lib.resolve(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    if args.cim:
        cfg = dataclasses.replace(cfg, cim_linear=True)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)

    dtype = args.param_dtype and getattr(torch, args.param_dtype)
    params = module.materialize(lm.param_specs(cfg),
                                torch.Generator(dev).manual_seed(args.seed),
                                dtype=dtype, device=dev)
    if mesh is not None:
        params = module.tree_map(torch.clone, module.local_params(
            params, lm.param_specs(cfg), mesh, cfg.sharding_overrides))
    engine = BatchedEngine(cfg, params, batch_slots=args.slots, s_max=128,
                           mesh=mesh, device=dev)

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
