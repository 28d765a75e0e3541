"""Training driver: the LM on the synthetic Zipf stream, with atomic
checkpoints, auto-resume and fault injection.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        [--smoke] [--steps 20] [--global-batch 8] [--seq-len 128] \
        [--n-micro 2] [--lr 3e-3] [--ckpt-dir DIR] [--ckpt-every 10] \
        [--step-deadline 300] [--seed 0] [--crash-at-step N] \
        [--metrics-out PATH] [--device cpu] [--param-dtype bfloat16]

Counterpart of ``repro.launch.train``, with its flags and behaviour:
  * auto-resume: a run continues from the newest complete checkpoint in
    ``--ckpt-dir``, bit for bit as if it had not stopped (the data is
    stateless by step);
  * a step slower than ``--step-deadline`` seconds logs a straggler line;
  * a checkpoint (parameters and AdamW state) every ``--ckpt-every``
    steps and after the last, the newest three kept;
  * ``--crash-at-step N`` exits hard (``os._exit(42)``) before step N;
  * ``--metrics-out`` writes the history as JSON.
``main`` returns the history, one ``{"step", "loss", "sec"}`` a step run
in this process; ``sec`` is the host time of the step up to its loss on
the host (unrounded, where the reference rounds to 0.01 s).  The weights
are drawn on the run's device from ``--seed`` (f32, the specs' dtype, or
``--param-dtype bfloat16``); the activations are in the configuration's
dtype (bf16 at full width, f32 under ``--smoke``).  AdamW warms up over 5
steps and decays over ``--steps``.  It runs on ``cuda`` unless
``--device cpu`` is given.

Bitwise resume needs every op to give the same bits on every run.
``main`` turns on ``torch.use_deterministic_algorithms(True)`` for its
duration and sets ``CUBLAS_WORKSPACE_CONFIG`` (unless set) before CUDA
starts, so an op without a deterministic path raises instead of
drifting.  On the card the training step's ops with a nondeterministic
default are the backward of the embedding lookup (``index_put_`` with
accumulation), of the cross-entropy's ``gather`` (``scatter_add_``) and
of the GQA heads' ``repeat_interleave`` (``index_add_``): each takes its
deterministic path; cuBLAS takes the fixed workspace.

``main(argv, mesh=...)`` runs the partitioned step: every rank of the
mesh (``launch.mesh``, over a process group the caller set up, e.g.
under ``torchrun``) makes the call with the same flags; each draws the
same weights, keeps its blocks of them (``nn.module.local_params``) and
their AdamW moments, and steps on its block of each microbatch (the
microbatch's rows over the mesh's "batch" axes, and its sequence over
"model" where the config's overrides put it there).  A checkpoint holds the
whole leaves, gathered from the blocks and written by rank 0; a resume
reads them whole and cuts each rank's blocks.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch
import torch.distributed

from repro_torch import device as device_lib
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.data.synthetic_lm import DataConfig, SyntheticLM
from repro_torch.models import lm
from repro_torch.nn import module
from repro_torch.train import checkpoint, optim, train_loop

CUBLAS_WORKSPACE = ":4096:8"


def main(argv=None, *, mesh=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--step-deadline", type=float, default=300.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--crash-at-step", type=int, default=-1,
                    help="fault injection: hard-exit at this step")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--param-dtype", default=None,
                    choices=("float32", "bfloat16"),
                    help="the weights' dtype (default: the specs', f32)")
    args = ap.parse_args(argv)

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    dev = device_lib.resolve(args.device)
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _train(args, dev, mesh)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)


class _Shares:
    """The rank's share of the training state under a mesh: its blocks
    of the parameter leaves (and so of their moments), its block of each
    microbatch (``lm.batch_axes`` under the config's overrides: its rows,
    and its block of the sequence where they put it over "model"), and
    the whole leaves for a checkpoint."""

    def __init__(self, cfg, mesh, n_micro: int, global_batch: int,
                 seq_len: int):
        rules = cfg.sharding_overrides
        self.specs = lm.param_specs(cfg)
        self.mesh, self.rules = mesh, rules
        self.axes = lm.batch_axes(cfg, "train_4k")
        self.layout = module.param_layout(self.specs, mesh, rules)
        self.plan = module.plan(mesh, rules,
                                batch=global_batch // n_micro,
                                seq_len=seq_len)

    def blocks(self, tree):
        return module.tree_map(torch.clone, module.local_params(
            tree, self.specs, self.mesh, self.rules))

    def rows(self, batch: dict) -> dict:
        """This rank's block of each leaf (n_micro, mb, ...) of a
        microbatched batch."""
        return module.blocks_like(
            batch, {k: (None,) + self.axes[k] for k in batch}, self.mesh,
            self.rules)

    def whole(self, tree):
        with torch.no_grad():
            return module.tree_map(lambda t, spec: module.gather_param(
                t, spec, self.mesh), tree, self.layout)

    def state(self, params, opt_state):
        return {"params": self.whole(params),
                "opt": optim.AdamWState(opt_state.step,
                                        self.whole(opt_state.mu),
                                        self.whole(opt_state.nu))}

    def cut(self, state):
        opt = state["opt"]
        return self.blocks(state["params"]), optim.AdamWState(
            opt.step, self.blocks(opt.mu), self.blocks(opt.nu))


def _train(args, dev: torch.device, mesh=None) -> list[dict]:
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    ocfg = optim.AdamWConfig(lr=args.lr, warmup_steps=5,
                             total_steps=args.steps)

    dtype = args.param_dtype and getattr(torch, args.param_dtype)
    params = module.materialize(lm.param_specs(cfg),
                                torch.Generator(dev).manual_seed(args.seed),
                                dtype=dtype, device=dev)
    opt_state = optim.adamw_init(params, ocfg)
    shares = mesh and _Shares(cfg, mesh, args.n_micro, args.global_batch,
                              args.seq_len)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq_len,
                                  global_batch=args.global_batch,
                                  seed=args.seed))

    start_step = 0
    restored = checkpoint.restore_latest(
        args.ckpt_dir, {"params": params, "opt": opt_state})
    if restored is not None:
        state, meta = restored
        params, opt_state = state["params"], state["opt"]
        start_step = meta["step"]
        print(f"[resume] restored step {start_step} from {args.ckpt_dir}")
    if shares:
        params, opt_state = shares.cut({"params": params, "opt": opt_state})

    step_fn = train_loop.build_train_step(
        cfg, shares and shares.plan, n_micro=args.n_micro, opt_cfg=ocfg)

    history = []
    for step in range(start_step, args.steps):
        if args.crash_at_step == step:
            print(f"[fault-injection] hard exit at step {step}", flush=True)
            os._exit(42)
        t0 = time.perf_counter()
        batch = {k: v.to(dev) for k, v in
                 data.batch_at(step, n_micro=args.n_micro).items()}
        if shares:
            batch = shares.rows(batch)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        if dt > args.step_deadline:
            print(f"[straggler] step {step} took {dt:.1f}s "
                  f"(deadline {args.step_deadline}s)", flush=True)
        history.append({"step": step, "loss": loss, "sec": dt})
        print(f"step {step:4d} loss {loss:.4f} "
              f"gnorm {float(metrics['grad_norm']):.3f} {dt:.2f}s",
              flush=True)
        if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
            state = shares.state(params, opt_state) if shares else \
                {"params": params, "opt": opt_state}
            if not shares or shares.mesh.rank == 0:
                path = checkpoint.save(args.ckpt_dir, step + 1, state,
                                       meta={"arch": cfg.name,
                                             "data_step": step + 1})
                print(f"[ckpt] saved {path}", flush=True)
            if shares:
                torch.distributed.barrier()
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f)
    return history


if __name__ == "__main__":
    main()
