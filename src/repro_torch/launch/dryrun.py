"""The dry run: one rank of the production mesh runs the port's step at
full width on tensors that hold no data, and counts it.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles every
(architecture x input shape x mesh) cell over 512 forced host devices
with ``ShapeDtypeStruct`` stand-ins.  Here one process joins a ``fake``
process group of 256 ranks (the 16 x 16 ("data", "model") mesh) or 512
(2 x 16 x 16, with "pod"), builds ``launch.mesh.make_production_mesh``
over it, and runs the step the card would run:

* ``train_4k``: ``train.train_loop.build_train_step`` (microbatched
  gradient accumulation, then AdamW) on (n_micro, mb, ...);
* ``prefill_32k``: ``models.lm.forward(..., prefill=True)`` under
  ``no_grad`` (the flash kernel #9, as its custom op);
* ``decode_32k`` / ``long_500k``: ``serve.engine.build_serve_step``, one
  token against a cache of ``s_max`` slots.

The state is this rank's: its block of every parameter leaf under the
config's sharding rules (``nn.module.param_layout``) in the
compute dtype, the AdamW moments of those blocks (``opt_profile``), and
the batch.  The port's mesh entry points take the whole batch on every
rank and cut each rank's tokens inside (``shard_map``'s edges),
so each rank holds the whole batch of ``models.lm.batch_specs``; the
reference gives each device its share per ``batch_axes``.  The tensors
are fake CUDA tensors (``FakeTensorMode``) where torch is built with
CUDA: they hold no data, allocate nothing, and every kernel wrapper on
the path takes them as the card's (#9's custom op runs its fake
implementation; no plain version runs).  A torch built without CUDA
aborts the process when autograd meets a fake CUDA tensor (it asks the
CUDA device guard for a stream), so there the state lies on ``meta``,
which the same wrappers take the same way; the counts do not depend on
the choice.  Collectives are issued as on the card, into the fake group,
which moves nothing.

What is counted (``count``), per device per step:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s total (the
  counterpart of ``cost_analysis``' FLOPs), by op in ``flops_by_op``;
* ``argument_size_in_bytes`` (the state's distinct storages),
  ``temp_size_in_bytes`` (the peak of the storages the step creates that
  are alive at once, tallied by a ``TorchDispatchMode`` that follows each
  storage until it is freed: the allocator's live bytes, without its
  caching), ``output_size_in_bytes`` and ``bytes_per_device`` =
  argument + peak temporaries (the counterpart of ``memory_analysis``);
* ``bytes_accessed``: every op's operands and results (views excluded),
  unfused;
* ``collectives_counted``: ``dist.collectives.wire_tally`` through
  ``roofline.analysis.collective_bytes`` (the reference's
  ``collectives_hlo``), and ``roofline_counted`` from them
  (``roofline_hlo``).

The primary ``roofline`` is ``roofline.flops_model.analyze``, as in the
reference.  Rank 0 is counted.  It stands for every rank: the blocks of
the layout are even, the dense layers run whole on every rank, and each
expert-parallel path pads its dispatch to its capacity, so every rank
runs the same ops on tensors of the same shapes and issues the same
collectives.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Results go to ``dryrun_results_torch/<arch>__<shape>__<single|multi>.json``
(a cell already there is skipped).  Importing this module changes
nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs import SHAPE_SKIPS, cells
from repro_torch.dist import collectives
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.nn import module
from repro_torch.roofline import analysis, flops_model
from repro_torch.serve import engine
from repro_torch.train import optim, train_loop

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "dryrun_results_torch")


def opt_profile(cfg: lm.LMConfig) -> tuple[optim.AdamWConfig, torch.dtype]:
    """The optimizer's memory profile by model scale: above 100B
    parameters bf16 moments, above 400B bf16 gradient accumulation too."""
    n = cfg.param_count()
    ocfg = optim.AdamWConfig(
        moment_dtype="bfloat16" if n > 100e9 else "float32")
    grad_dtype = torch.bfloat16 if n > 400e9 else torch.float32
    return ocfg, grad_dtype


def n_micro_for(cfg: lm.LMConfig, shape: str, mesh) -> int:
    """Microbatches of a train cell: one or two sequences per device row
    a microbatch, at most 8."""
    if shape != "train_4k":
        return 1
    gb = lm.SHAPES[shape]["batch"]
    dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    per_dev_seqs = gb // dp
    return max(1, min(per_dev_seqs, 8))


@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a ``fake`` process group of
    ``world_size`` ranks, torn down on exit.  Raises where a group
    exists already or this torch has no fake backend."""
    if dist.is_initialized():
        raise RuntimeError("the dry run sets up its own fake process "
                           "group; one exists already")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("this torch has no fake process group "
                           "(torch.testing._internal.distributed."
                           "fake_pg)") from e
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_device() -> str:
    """The device of the dry run's tensors: ``cuda`` (fake) where torch
    is built with CUDA, else ``meta`` (module doc)."""
    return "cuda" if torch.backends.cuda.is_built() else "meta"


@contextlib.contextmanager
def no_data(device: str):
    """The mode the dry run's state is made and stepped in: fake tensors
    for ``cuda``; ``meta`` tensors need none."""
    if torch.device(device).type == "meta":
        yield
        return
    from torch._subclasses.fake_tensor import FakeTensorMode
    # a real tensor met inside (a host constant) is taken as a fake one
    with FakeTensorMode(allow_non_fake_inputs=True):
        yield


def block_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The shape of a rank's block of a leaf laid out by ``spec``."""
    out = list(shape)
    for d, part in enumerate(spec):
        if part is not None:
            out[d] //= mesh.axis_size(part)
    return tuple(out)


def abstract_params(cfg: lm.LMConfig, mesh, device) -> dict:
    """Empty tensors of this rank's parameter blocks (whole leaves with
    no mesh), in the compute dtype, on ``device``."""
    specs = lm.param_specs(cfg)
    if mesh is None:
        return module.tree_map(lambda s: torch.empty(
            s.shape, dtype=cfg.compute_dtype, device=device), specs)
    layout = module.param_layout(specs, mesh, cfg.sharding_overrides)
    return module.tree_map(lambda s, spec: torch.empty(
        block_shape(s.shape, spec, mesh), dtype=cfg.compute_dtype,
        device=device), specs, layout)


def build(cfg: lm.LMConfig, shape: str, mesh, device, *,
          n_micro: int | None = None, batch: int | None = None,
          seq: int | None = None, params=None):
    """The step of a cell on empty tensors of ``device``: (step, its
    arguments, the result's extra keys, tokens a step).  ``batch`` /
    ``seq`` override the cell's; ``params`` are the rank's blocks where
    the caller has them (else ``abstract_params``)."""
    sh = lm.SHAPES[shape]
    b, s = batch or sh["batch"], seq or sh["seq"]
    if params is None:
        params = abstract_params(cfg, mesh, device)
    data = lm.batch_specs(cfg, shape, b, s, device=device)
    if sh["kind"] == "train":
        ocfg, grad_dtype = opt_profile(cfg)
        nm = n_micro or n_micro_for(cfg, shape, mesh)
        data = train_loop.microbatch(data, nm)
        step = train_loop.build_train_step(cfg, mesh, n_micro=nm,
                                           opt_cfg=ocfg,
                                           grad_dtype=grad_dtype)
        extra = {"n_micro": nm, "moment_dtype": ocfg.moment_dtype,
                 "grad_dtype": str(grad_dtype).removeprefix("torch.")}
        return step, (params, optim.adamw_init(params, ocfg), data), \
            extra, b * s
    if sh["kind"] == "prefill":
        def prefill_step(params, batch):
            logits, _, cache = lm.forward(params, batch, cfg, prefill=True,
                                          mesh=mesh)
            return logits, cache
        return prefill_step, (params, data), {}, b * s
    cache = lm.cache_on(cfg, b, s, device)
    serve = engine.build_serve_step(cfg, mesh)

    def serve_step(params, cache, tokens, pos):
        return serve(params, cache, tokens, pos, None)

    return serve_step, (params, cache, data["tokens"], data["pos"]), \
        {"cache_seq_len": s}, b


def _storages(tree) -> dict:
    """The distinct storages of a tree's tensors: {id: bytes}."""
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Bytes(TorchDispatchMode):
    """The bytes a step's ops read and write, and the peak of the
    storages it creates that are alive at once.  A storage is followed
    from the op that first returns it until Python frees it (a finalizer
    on the storage, whose Python object lives as long as the storage);
    the ``known`` storages (the arguments) are not counted."""

    def __init__(self, known):
        super().__init__()
        self._seen = set(known)
        self.live = self.peak = self.accessed = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)
        if not view:
            self.accessed += sum(
                _nbytes(t) for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)) + sum(map(_nbytes, outs))
        for t in outs:
            st = t.untyped_storage()
            if st._cdata in self._seen:
                continue
            self._seen.add(st._cdata)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)
        return out


def count(step, *args) -> tuple[dict, object]:
    """Run ``step(*args)`` under the counters (module doc): (the counts,
    the step's result)."""
    argument = _storages(args)
    t0 = time.perf_counter()
    with collectives.wire_tally() as tally, \
            FlopCounterMode(display=False) as flops, _Bytes(argument) as mem:
        out = step(*args)
    seconds = time.perf_counter() - t0
    by_op = flops.get_flop_counts().get("Global", {})
    outputs = {k: v for k, v in _storages(out).items() if k not in argument}
    arg_bytes = sum(argument.values())
    return {
        "count_s": round(seconds, 3),
        "flops": int(flops.get_total_flops()),
        "flops_by_op": {str(op): int(n) for op, n in by_op.items()},
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": sum(outputs.values()),
        "temp_size_in_bytes": mem.peak,
        "bytes_per_device": arg_bytes + mem.peak,
        "bytes_accessed": mem.accessed,
        "tally": tally,
    }, out


def lower_cell(arch: str, shape: str, multi_pod: bool,
               do_compile: bool = True, *, n_micro: int | None = None):
    """One cell on rank 0 of the fake production mesh (256 ranks, or 512
    with ``multi_pod``): its state, and with ``do_compile`` its step
    counted.  ``n_micro`` overrides ``n_micro_for`` in a train cell.
    Returns the result dict (module doc)."""
    cfg = configs.get_config(arch)
    n_dev = 512 if multi_pod else 256
    sh = lm.SHAPES[shape]
    kind = sh["kind"]
    dev = fake_device()
    with fake_world(n_dev), no_data(dev):
        mesh = make_production_mesh(multi_pod=multi_pod)
        step, args, extra, n_tokens = build(cfg, shape, mesh, dev,
                                            n_micro=n_micro)
        result = {
            "arch": arch, "shape": shape,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "n_devices": n_dev, "kind": kind, "rank": 0,
            "device": f"{dev} (fake)" if dev == "cuda" else dev,
            "params_total": cfg.param_count(),
            "params_active": cfg.active_param_count(),
            **extra,
        }
        if not do_compile:
            result["argument_size_in_bytes"] = sum(_storages(args).values())
            result["lowered_only"] = True
            return result
        counts, _ = count(step, *args)
    tally = counts.pop("tally")
    result.update(counts)
    mf = analysis.model_flops(cfg.active_param_count(), n_tokens,
                              "train" if kind == "train" else "serve", n_dev)
    result["roofline_counted"] = analysis.from_counts(
        counts["flops"], counts["bytes_accessed"], tally, mf).as_dict()
    result["collectives_counted"] = analysis.collective_bytes(tally)
    ocfg, grad_dtype = opt_profile(cfg)
    result["roofline"] = flops_model.analyze(
        cfg, shape, flops_model.mesh_for(multi_pod),
        n_micro=extra.get("n_micro", 1),
        grad_bytes=2 if grad_dtype == torch.bfloat16 else 4,
        moment_bytes=2 if ocfg.moment_dtype == "bfloat16" else 4)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(lm.SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--no-compile", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        todo = cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        if (args.arch, args.shape) in SHAPE_SKIPS:
            print(f"SKIP {args.arch} x {args.shape}: "
                  f"{SHAPE_SKIPS[(args.arch, args.shape)]}")
            return
        todo = [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for arch, shape in todo:
        for multi in meshes:
            tag = f"{arch}__{shape}__{'multi' if multi else 'single'}"
            out_path = os.path.join(args.out, tag + ".json")
            if os.path.exists(out_path):
                print(f"[cached] {tag}")
                continue
            print(f"[dry run] {tag} ...", flush=True)
            try:
                t0 = time.time()
                res = lower_cell(arch, shape, multi,
                                 do_compile=not args.no_compile)
                res["wall_s"] = round(time.time() - t0, 1)
                with open(out_path, "w") as f:
                    json.dump(res, f, indent=1)
                r = res.get("roofline", {})
                print(f"  OK {res['wall_s']}s  dominant={r.get('dominant')} "
                      f"compute={r.get('compute_s', 0):.4f}s "
                      f"memory={r.get('memory_s', 0):.4f}s "
                      f"coll={r.get('collective_s', 0):.4f}s "
                      f"mem/dev={res.get('bytes_per_device', 0)/2**30:.2f}GiB"
                      f" counted flops={res.get('flops', math.nan):.4g}",
                      flush=True)
            except Exception as e:
                failures.append((tag, repr(e)))
                print(f"  FAIL {tag}: {e}", flush=True)
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print("\nall cells counted")


if __name__ == "__main__":
    main()
