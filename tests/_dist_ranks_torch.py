"""The port's multi-rank results for ``test_torch_dist.py`` and
``test_torch_pipeline.py``, on gloo ranks of the CPU.

    python tests/_dist_ranks_torch.py moe IN.npz OUT.npz   # 8 ranks
    python tests/_dist_ranks_torch.py gpipe IN.npz OUT.npz # 2 ranks
    python tests/_dist_ranks_torch.py dryrun - OUT.npz     # 8 ranks

Spawns the ranks on a TCP store at a free port of 127.0.0.1 (each with
one thread: the suite runs under ``pytest -n``), reads the operands the
JAX script wrote, runs the port's counterpart of every case through a
:class:`repro_torch.launch.mesh.Mesh`, and writes rank 0's results (and
every rank's routing) under the reference's keys.  ``dryrun`` needs no
input: it counts rank 0's train and decode steps of ``R.DRY_ARCHS``
(``launch.dryrun.count``) and runs ``loss_fn`` under each remat policy,
for ``test_torch_dryrun.py``.
"""

import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

import dataclasses  # noqa: E402

import _dist_cases as R  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.dist import collectives, pipeline  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_host_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import lm  # noqa: E402
from repro_torch.nn import moe, module  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import checkpoint, optim, train_loop  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tree(z, prefix: str) -> dict:
    """The nested dict of tensors stored under ``prefix/``."""
    out: dict = {}
    for key in z.files:
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(z[key])
    return out


def _flat(tree, prefix: str) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.detach().numpy()}


def _path(kind, p, x, mesh, cf, kw, stats=None, specs=None):
    if kind == "a2a":
        return moe.moe_a2a(p, x, k=R.K, mesh=mesh, capacity_factor=cf,
                           stats=stats, specs=specs, **kw)
    if kind == "2d":
        return moe.moe_2d(p, x, k=R.K, mesh=mesh, capacity_factor=cf,
                          expert_axes=("data",), stats=stats, specs=specs,
                          **kw)
    if kind == "dense_ep":
        return moe.moe_dense_ep(p, x, k=R.K, mesh=mesh, specs=specs)
    return moe.moe_dense_ep_2d(p, x, k=R.K, mesh=mesh, expert_axes=("data",),
                               specs=specs)


def _gathered(tree, layout, mesh):
    """The whole leaves from this rank's blocks laid out by ``layout``."""
    with torch.no_grad():
        return module.tree_map(
            lambda t, spec: module.gather_param(t, spec, mesh), tree, layout)


def _held_cases(z, mesh) -> dict:
    """Every path on the MoE parameters held as this rank's blocks (the
    layout of ``R.HELD``'s rules), against the same cases on whole
    leaves; gradients through ``moe_2d`` and ``moe_a2a`` gathered whole."""
    p = _tree(z, "in/moe")
    x = torch.from_numpy(z["in/x8"])
    pspecs = moe.moe_specs(R.D, R.F, R.E)
    res = {}
    for kind, (case, rules) in R.HELD.items():
        layout = module.param_layout(pspecs, mesh, rules)
        local = module.local_params(p, pspecs, mesh, rules)
        y, aux = _path(kind, local, x, mesh, 1.25, {}, specs=layout)
        res[f"out/held_{kind}/y"], res[f"out/held_{kind}/aux"] = (
            y.numpy(), aux.numpy())
        res[f"out/held_{kind}/experts"] = np.int64(local["w_in"].shape[0])
        if kind in ("2d", "a2a"):
            live = {k: v.clone().requires_grad_() for k, v in local.items()}
            xg = x.clone().requires_grad_()
            y, aux = _path(kind, live, xg, mesh, 1.25, {}, specs=layout)
            (torch.sum(y ** 2) + 0.01 * aux).backward()
            res.update(_flat(_gathered({k: v.grad for k, v in live.items()},
                                       layout, mesh),
                             f"out/held_grad_{kind}/p"))
            res[f"out/held_grad_{kind}/x"] = xg.grad.numpy()
    return res


def _moe_cases(z, mesh) -> dict:
    p = _tree(z, "in/moe")
    xs = {R.S: torch.from_numpy(z["in/x8"]), 6: torch.from_numpy(z["in/x6"])}
    res = {}
    for name, kind, cf, s, kw in R.CASES:
        stats = {} if kind in ("a2a", "2d") else None
        y, aux = _path(kind, p, xs[s], mesh, cf, kw, stats)
        res[f"out/{name}/y"], res[f"out/{name}/aux"] = y.numpy(), aux.numpy()
        if stats is not None and "wire_dtype" not in kw:
            got = [None] * mesh.size
            dist.all_gather_object(got, (stats["idx"].numpy(),
                                         stats["kept"].numpy(),
                                         stats["dropped"]))
            res[f"out/{name}/idx"] = np.stack([g[0] for g in got])
            res[f"out/{name}/kept"] = np.stack([g[1] for g in got])
            res[f"out/{name}/dropped"] = np.array([g[2] for g in got])
    for kind in ("2d", "a2a"):
        live = {k: v.clone().requires_grad_() for k, v in p.items()}
        x = xs[R.S].clone().requires_grad_()
        y, aux = _path(kind, live, x, mesh, 1.25, {})
        (torch.sum(y ** 2) + 0.01 * aux).backward()
        res.update(_flat({k: v.grad for k, v in live.items()},
                         f"out/grad_{kind}/p"))
        res[f"out/grad_{kind}/x"] = x.grad.numpy()
    return res


# specs of an (8, 8) tensor for the shard / unshard round trip
ROUNDTRIP_SPECS = {"data_rows": ("data",), "model_cols": (None, "model"),
                   "both": ("data", "model"), "joint_rows": (("data", "model"),),
                   "replicated": ()}


def _roundtrip(mesh) -> dict:
    """x -> shard -> unshard -> sum(y * w): y must be x on every rank,
    and the gradient w, not scaled by the number of ranks."""
    out = {}
    x0 = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    w = torch.linspace(-1.0, 1.0, 64).reshape(8, 8)
    for name, spec in ROUNDTRIP_SPECS.items():
        x = x0.clone().requires_grad_()
        y = module.unshard(module.shard(x, spec, mesh), spec, mesh)
        torch.sum(y * w).backward()
        out[f"out/roundtrip/{name}/y"] = y.detach().numpy()
        out[f"out/roundtrip/{name}/grad"] = x.grad.numpy()
        out[f"out/roundtrip/{name}/block"] = tuple(
            module.shard(x0, spec, mesh).shape)
    return out


def _meshes() -> dict:
    """``make_host_mesh`` over the 8 ranks; the production mesh refuses
    a world of 8; every rank's coordinates on a (2, 2, 2) ("pod",
    "data", "model") mesh, its joint index over ("pod", "data") and over
    "model", and the errors of an axis out of order and of a missing
    one."""
    host = make_host_mesh()
    try:
        make_production_mesh()
    except ValueError:
        refused = True
    else:
        refused = False
    m = Mesh((2, 2, 2), ("pod", "data", "model"))
    c = m.coords_of(m.rank)
    errors = []
    for bad in (lambda: m.axis_index(("data", "pod")),
                lambda: m.axis_size("expert")):
        try:
            bad()
        except ValueError:
            errors.append(True)
        else:
            errors.append(False)
    mine = (m.rank, [c["pod"], c["data"], c["model"]],
            m.rank_of(c), m.axis_index(("pod", "data")),
            m.axis_index("model"), errors)
    got = [None] * m.size
    dist.all_gather_object(got, mine)
    return {"out/host_mesh": np.array([host.shape["data"],
                                       host.shape["model"]]),
            "out/production_refused": np.array(refused),
            "out/coords/rank": np.array([g[0] for g in got]),
            "out/coords/coords": np.array([g[1] for g in got]),
            "out/coords/rank_of": np.array([g[2] for g in got]),
            "out/coords/pod_data": np.array([g[3] for g in got]),
            "out/coords/model": np.array([g[4] for g in got]),
            "out/coords/errors": np.array([g[5] for g in got])}


def _lm_cases(z, mesh, arch, ckpt_dir) -> dict:
    """The LM through the mesh on this rank's blocks of the parameters
    (``local_params``); gradients and stepped parameters gathered whole.
    Then the elastic path: the blocks of a (1, 8) layout gathered and
    saved, restored on the (2, 4) mesh, through ``forward``."""
    cfg = base.reduced(configs.ARCHS[arch])
    rules = cfg.sharding_overrides
    specs = lm.param_specs(cfg)
    layout = module.param_layout(specs, mesh, rules)
    full = _tree(z, f"in/{arch}/params")
    params = module.local_params(full, specs, mesh, rules)
    batch = {"tokens": torch.from_numpy(z[f"in/{arch}/tokens"])}
    dec = torch.from_numpy(z[f"in/{arch}/decode_tokens"])
    out = {}
    logits, aux = lm.forward(params, batch, cfg, mesh=mesh)
    out[f"out/{arch}/logits"], out[f"out/{arch}/aux"] = logits, aux
    live = module.tree_map(lambda t: t.clone().requires_grad_(), params)
    loss, parts = lm.loss_fn(live, batch, cfg, mesh=mesh)
    loss.backward()
    out[f"out/{arch}/loss"], out[f"out/{arch}/ce"] = loss, parts["ce"]
    grads = module.tree_map(lambda t: t.grad, live)
    out.update(_flat(_gathered(grads, layout, mesh), f"out/{arch}/grads"))
    out[f"out/{arch}/experts_held"] = np.int64(
        params["layers"]["b0"]["moe"]["w_in"].shape[1])
    last, _, cache = lm.forward(params, batch, cfg, prefill=True, mesh=mesh)
    out[f"out/{arch}/prefill_logits"] = last
    cache = lm.pad_cache(cache, cfg, R.LM_S + R.LM_DECODE)
    for i in range(R.LM_DECODE):
        pos = torch.full((R.LM_B,), R.LM_S + i, dtype=torch.int64)
        lg, cache = lm.decode_step(params, cache, dec[:, i:i + 1], pos, cfg,
                                   mesh=mesh)
        out[f"out/{arch}/decode{i}"] = lg
    eng = engine.BatchedEngine(cfg, params, batch_slots=len(R.ENGINE_PROMPTS),
                               s_max=R.ENGINE_S_MAX, mesh=mesh, device="cpu")
    for uid in range(len(R.ENGINE_PROMPTS)):
        eng.submit(engine.Request(uid, z[f"in/{arch}/prompt{uid}"].tolist(),
                                  R.ENGINE_NEW))
    for req in eng.run():
        out[f"out/{arch}/engine{req.uid}"] = np.array(req.generated)
    out[f"out/{arch}/eval_loss"] = train_loop.build_eval_step(cfg, mesh)(
        params, batch)["loss"]
    # one train step through the mesh is AdamW on the mesh's gradients,
    # clipped by the whole gradient's norm
    opt = optim.AdamWConfig()
    step = train_loop.build_train_step(cfg, mesh, opt_cfg=opt)
    stepped, _, metrics = step(params, optim.adamw_init(params, opt),
                               train_loop.microbatch(batch, 1))
    gnorm = train_loop.block_norm(grads, cfg, mesh)
    want, _, _ = optim.adamw_update(grads, optim.adamw_init(params, opt),
                                    params, opt, gnorm)
    out[f"out/{arch}/train_step_err"] = np.float64(max(
        float((a - b).abs().max()) for a, b in zip(module.leaves(stepped),
                                                   module.leaves(want))))
    out[f"out/{arch}/block_norm"] = metrics["grad_norm"]
    out[f"out/{arch}/whole_norm"] = optim.global_norm(
        _gathered(grads, layout, mesh))
    out[f"out/{arch}/train_step_params"] = np.concatenate(
        [t.detach().reshape(-1).numpy()
         for t in module.leaves(_gathered(stepped, layout, mesh))])
    # saved from the blocks of another layout, restored on this mesh
    host = make_host_mesh()
    whole = _gathered(module.local_params(full, specs, host, rules),
                      module.param_layout(specs, host, rules), host)
    if dist.get_rank() == 0:
        checkpoint.save(ckpt_dir, 1, {"params": whole})
    dist.barrier()
    restored, _ = checkpoint.restore(
        ckpt_dir, 1, {"params": full},
        shardings={"params": module.shardings(specs, mesh, rules)})
    restored = restored["params"]
    out[f"out/{arch}/restored_blocks_equal"] = np.array(all(
        torch.equal(a, b) for a, b in zip(module.leaves(restored),
                                          module.leaves(params))))
    out[f"out/{arch}/restored_logits"] = lm.forward(restored, batch, cfg,
                                                    mesh=mesh)[0]
    dist.barrier()
    return {k: v.detach().numpy() if torch.is_tensor(v) else v
            for k, v in out.items()}


def dry_config(arch: str, policy: str = "nothing"):
    return dataclasses.replace(base.reduced(configs.ARCHS[arch]), remat=True,
                               remat_policy=policy)


def _tally_keys(prefix: str, tally) -> dict:
    return {**{f"{prefix}/{k}_bytes": np.int64(v)
               for k, v in tally.bytes.items()},
            **{f"{prefix}/{k}_count": np.int64(v)
               for k, v in tally.count.items()}}


def _dry_cases(mesh) -> dict:
    """Rank 0's counts of a train step and a decode step of each reduced
    config on its blocks of seeded parameters; ``loss_fn``'s loss and
    gradient blocks under each remat policy, and the collectives of its
    forward and backward."""
    out = {}
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, 100, (R.DRY_B, R.DRY_S), generator=g)
    dec = torch.randint(0, 100, (R.DRY_B, 1), generator=g)
    pos = torch.full((R.DRY_B,), R.DRY_S, dtype=torch.int64)
    for arch in R.DRY_ARCHS:
        cfg = dry_config(arch)
        specs = lm.param_specs(cfg)
        full = module.materialize(specs, torch.Generator().manual_seed(1),
                                  device="cpu")
        params = module.local_params(full, specs, mesh,
                                     cfg.sharding_overrides)
        step, args, _, _ = dryrun.build(cfg, "train_4k", mesh, "cpu",
                                        n_micro=1, batch=R.DRY_B,
                                        seq=R.DRY_S, params=params)
        counts, _ = dryrun.count(step, params, args[1],
                                 {"tokens": tokens[None]})
        out[f"train/{arch}/flops"] = np.int64(counts["flops"])
        out.update(_tally_keys(f"train/{arch}", counts["tally"]))
        step, args, _, _ = dryrun.build(cfg, "decode_32k", mesh, "cpu",
                                        batch=R.DRY_B, seq=R.DRY_S_MAX,
                                        params=params)
        counts, _ = dryrun.count(step, params, args[1], dec, pos)
        out[f"decode/{arch}/flops"] = np.int64(counts["flops"])
        out.update(_tally_keys(f"decode/{arch}", counts["tally"]))
        first = None
        for policy in R.POLICIES:
            pcfg = dry_config(arch, policy)
            live = module.tree_map(lambda t: t.clone().requires_grad_(),
                                   params)
            flat = module.leaves(live)
            with collectives.wire_tally() as tally:
                loss, _ = lm.loss_fn(live, {"tokens": tokens}, pcfg,
                                     mesh=mesh)
                grads = torch.autograd.grad(loss, flat, allow_unused=True)
            got = [loss.detach()] + [torch.zeros(()) if t is None else t
                                     for t in grads]
            if first is None:
                first = got
            out[f"remat/{arch}/{policy}/equal"] = np.array(all(
                torch.equal(a, b) for a, b in zip(got, first)))
            out[f"remat/{arch}/{policy}/loss"] = loss.detach().numpy()
            out.update(_tally_keys(f"remat/{arch}/{policy}", tally))
    # the pipeline's ring shift over "pod": a collective-permute of what
    # each rank receives
    ring = Mesh((2, R.TP), ("pod", "model"))
    with collectives.wire_tally() as tally:
        pipeline._ring(torch.ones(3, 4), ring, "pod")
    out.update(_tally_keys("ring", tally))
    return out


def _gpipe_case(z, mesh) -> dict:
    params = _tree(z, "in/params")
    x_mb = torch.from_numpy(z["in/x_mb"])
    y = pipeline.gpipe(lambda p, x: torch.tanh(x @ p["w"]), params, x_mb,
                       mesh)
    return {"out/y": y.numpy(),
            "out/bubble": np.float64(pipeline.bubble_fraction(
                x_mb.shape[0], mesh.shape["pod"]))}


def _worker(rank: int, world: int, port: int, what: str, src: str,
            dst: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        if what == "dryrun":
            res = _dry_cases(Mesh((2, R.TP), ("data", "model")))
            if rank == 0:
                np.savez(dst, **res)
            dist.barrier()
            return
        z = np.load(src)
        if what == "moe":
            mesh = Mesh((2, R.TP), ("data", "model"))
            res = {**_moe_cases(z, mesh), **_held_cases(z, mesh),
                   **_roundtrip(mesh), **_meshes()}
            for arch in R.LM_ARCHS:
                res.update(_lm_cases(z, mesh, arch, os.path.join(
                    os.path.dirname(dst), f"ckpt_{arch}")))
        else:
            res = _gpipe_case(z, Mesh((world,), ("pod",)))
        everywhere = [None] * world
        dist.all_gather_object(everywhere, {
            k: np.asarray(v) for k, v in res.items()
            if "/y" in k or "logits" in k or "train_step_params" in k})
        if rank == 0:
            # every rank returns the same full outputs
            for other in everywhere[1:]:
                for k, v in other.items():
                    res[f"rank_spread/{k}"] = np.maximum(
                        res.get(f"rank_spread/{k}", 0.0),
                        np.abs(np.asarray(v, np.float64) - res[k]).max())
            np.savez(dst, **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(what: str, src: str, dst: str) -> None:
    world = 8 if what in ("moe", "dryrun") else 2
    mp.start_processes(_worker, args=(world, _free_port(), what, src, dst),
                       nprocs=world, join=True, start_method="spawn")


if __name__ == "__main__":
    main(*sys.argv[1:4])
