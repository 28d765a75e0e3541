"""Time smollm-135m's decode step and ``BatchedEngine`` in the PyTorch
port, for one tree or for several trees on the same card.

    python3 scripts/time_lm_decode.py [--device cpu]
    python3 scripts/time_lm_decode.py --trees PARENT CHANGE [...]

One run, on the ``repro_torch`` that ``PYTHONPATH`` finds: random weights
from seed 0 (as ``launch.serve`` draws them); a decode step at batch 8
against a fresh 2080-slot cache (ms, best of three runs of ten, by CUDA
events on the card), the device kernels one step launches (under
``torch.profiler``), and ``BatchedEngine`` at ``launch.serve``'s defaults
(8 requests of 4-7 tokens, 4 slots, 12 new tokens, s_max 128) in tokens/s,
best of two runs after a warm-up.  It prints one JSON object as its last
line.

``--trees`` runs the script once on each checkout's ``src`` in the order
given, then once more on each in the reverse order (PARENT, CHANGE,
CHANGE, PARENT), each in its own process, and prints the records, the
card's name and power limit, and a JSON object of every tree's runs
(keyed by the checkout's directory name) as its last line.  Nothing here
launches a kernel of ``src/repro_torch/csrc``, so nothing is built.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ARCH = "smollm-135m"
BATCH, SLOTS_TO, POS = 8, 2080, 2048
N_REQUESTS, SLOTS, NEW, S_MAX = 8, 4, 12, 128


def _wall_ms(fn, reps: int, dev) -> float:
    import torch

    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def run_one(device: str) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.nn import module
    from repro_torch.serve import engine as engine_lib

    dev = torch.device(device)
    cfg = get_config(ARCH)
    params = module.materialize(lm.param_specs(cfg),
                                torch.Generator(dev).manual_seed(0),
                                device=dev)
    cache = lm.init_cache(cfg, BATCH, SLOTS_TO, device=dev)
    tok = torch.zeros((BATCH, 1), dtype=torch.long, device=dev)
    pos = torch.full((BATCH,), POS, device=dev)
    step = lambda: lm.decode_step(params, cache, tok, pos, cfg)
    res = {"arch": ARCH, "device": device,
           "decode_step_ms_all": [_wall_ms(step, 10, dev) for _ in range(3)]}
    res["decode_step_ms"] = min(res["decode_step_ms_all"])
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        kind = torch.autograd.DeviceType.CUDA
        res["kernels_per_step"] = sum(
            1 for e in prof.profiler.kineto_results.events()
            if e.device_type() == kind)

    rs = np.random.RandomState(22)
    prompts = [[int(t) for t in rs.randint(0, cfg.vocab_size, 4 + u % 4)]
               for u in range(N_REQUESTS)]

    def serve() -> tuple[float, int]:
        eng = engine_lib.BatchedEngine(cfg, params, batch_slots=SLOTS,
                                       s_max=S_MAX, device=dev)
        for uid, prompt in enumerate(prompts):
            eng.submit(engine_lib.Request(uid=uid, prompt=prompt,
                                          max_new_tokens=NEW))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run(max_rounds=256)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0, sum(len(r.generated) for r in done)

    serve()
    walls = [serve() for _ in range(2)]
    res["engine_tokens"] = walls[0][1]
    res["engine_tokens_per_s_all"] = [n / w for w, n in walls]
    res["engine_tokens_per_s"] = max(res["engine_tokens_per_s_all"])
    return res


def run_trees(trees: list[str], device: str) -> dict:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip()
    except FileNotFoundError:
        smi = "no nvidia-smi"
    print(smi, flush=True)
    names = [os.path.basename(os.path.abspath(t)) for t in trees]
    out: dict = {"card": smi, "runs": {name: [] for name in names}}
    for name, tree in [*zip(names, trees), *reversed([*zip(names, trees)])]:
        env = dict(os.environ, PYTHONPATH=os.path.join(
            os.path.abspath(tree), "src"))
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--device", device],
            env=env, capture_output=True, text=True, check=False)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"{name} run failed ({proc.returncode})")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        out["runs"][name].append(rec)
        print(name, json.dumps(rec), flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trees", nargs="+", metavar="TREE")
    args = ap.parse_args(argv)
    if args.trees:
        res = run_trees(args.trees, args.device)
    else:
        res = run_one(args.device)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
