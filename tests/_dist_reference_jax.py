"""The JAX package's multi-device results for ``test_torch_dist.py``.

    python tests/_dist_reference_jax.py OUT.npz

Runs on 8 simulated host devices (a (2, 4) ("data", "model") mesh, as
``tests/test_dist.py`` sets them up) and writes the operands, drawn from
``numpy.random.RandomState``, with the reference's results: the four
expert-parallel MoE paths at capacity factors 8.0 and 1.25, the routing
and kept assignments of ``moe_a2a`` and ``moe_2d`` (the reference's
``router_topk`` and ``_dispatch_onehot`` on each device's tokens),
``moe_2d`` on the int8 wire, ``jax.grad`` through ``moe_2d`` and
``moe_a2a``, and the reduced kimi-k2 and arctic LMs' forward,
``loss_fn`` with its gradients, a prefill with three decode steps and
a two-slot ``BatchedEngine``, all through the mesh.  Keys are ``in/...`` and ``out/...``, nested
trees flattened with "/".

    python tests/_dist_reference_jax.py OUT.npz part

writes the partitioned step of ``PART_ARCHS`` instead (``part_results``)
for ``test_torch_partition.py``.
"""

import os
import sys

# On a loaded host (the suite under ``pytest -n``, the gloo ranks beside
# this process) a simulated device's thread can reach a collective's
# rendezvous later than XLA's default 40 s, which aborts the process.
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_cpu_collective_call_terminate_timeout_"
                           "seconds=600")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _dist_cases import (B, CASES, D, E, ENGINE_NEW,  # noqa: E402
                         ENGINE_PROMPTS, ENGINE_S_MAX, F, K, LM_ARCHS, LM_B,
                         LM_DECODE, LM_S, PART_ARCHS, PART_B, PART_DECODE,
                         PART_NEW, PART_PAD, PART_PROMPTS, PART_S_MAX,
                         PART_SEED, PART_SLOTS, S, TP,
                         part_config, part_inputs, part_patches, part_seq)
from repro import compat, configs  # noqa: E402
from repro.configs import base  # noqa: E402
from repro.models import lm  # noqa: E402
from repro.nn import module, moe  # noqa: E402
from repro.serve import engine  # noqa: E402
from repro.train import optim  # noqa: E402


def flatten(tree, prefix: str) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def moe_inputs(rs):
    p = {"router": rs.normal(size=(D, E)) * 0.5,
         "w_in": rs.normal(size=(E, D, F)) / np.sqrt(D),
         "w_gate": rs.normal(size=(E, D, F)) / np.sqrt(D),
         "w_out": rs.normal(size=(E, F, D)) / np.sqrt(F)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    xs = {s: rs.normal(size=(B, s, D)).astype(np.float32) for s in (S, 6)}
    return p, xs


def run_path(path, p, x, mesh, cf, kw):
    if path == "a2a":
        return moe.moe_a2a(p, x, k=K, mesh=mesh, capacity_factor=cf, **kw)
    if path == "2d":
        return moe.moe_2d(p, x, k=K, mesh=mesh, capacity_factor=cf,
                          expert_axes=("data",), **kw)
    if path == "dense_ep":
        return moe.moe_dense_ep(p, x, k=K, mesh=mesh)
    return moe.moe_dense_ep_2d(p, x, k=K, mesh=mesh, expert_axes=("data",))


def routing(path, p, x, mesh, cf, kw):
    """Each device's routed tokens through the reference's router and
    dispatch: winners (8, T, k) and kept assignments (8, T, k), devices
    in ("data", "model") order."""
    s = x.shape[1]
    seq = kw.get("seq_sharded", False) and s % TP == 0
    if path == "2d":
        seq = s % TP == 0

    def local(router, xl):
        xt = xl.reshape(-1, xl.shape[-1])
        if path == "a2a" and not seq:
            t = xt.shape[0] // TP
            xt = jax.lax.dynamic_slice_in_dim(
                xt, jax.lax.axis_index("model") * t, t, 0)
        gate, idx, _ = moe.router_topk(xt @ router, K)
        cap = max(1, int(np.ceil(xt.shape[0] * K / E * cf)))
        disp, _ = moe._dispatch_onehot(idx, gate, E, cap, xt.dtype)
        kept = jnp.take_along_axis(disp.sum(-1), idx, axis=1) > 0
        return idx[None], kept[None]

    out = P(("data", "model"))
    fn = compat.shard_map(local, mesh, in_specs=(
        P(), P("data", "model" if seq else None, None)),
        out_specs=(out, out))
    return jax.jit(fn)(p["router"], x)


def lm_results(arch, mesh, rs) -> dict:
    cfg = base.reduced(configs.ARCHS[arch])
    params = module.materialize(lm.param_specs(cfg), jax.random.PRNGKey(0))
    tokens = rs.randint(0, cfg.vocab_size, (LM_B, LM_S)).astype(np.int32)
    dec = rs.randint(0, cfg.vocab_size, (LM_B, LM_DECODE)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    out = {**flatten(params, f"in/{arch}/params"),
           f"in/{arch}/tokens": tokens, f"in/{arch}/decode_tokens": dec}
    logits, aux = jax.jit(lambda p, b: lm.forward(p, b, cfg, mesh))(
        params, batch)
    out[f"out/{arch}/logits"], out[f"out/{arch}/aux"] = logits, aux
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p: lm.loss_fn(p, batch, cfg, mesh), has_aux=True))(params)
    out[f"out/{arch}/loss"] = loss
    out[f"out/{arch}/ce"] = parts["ce"]
    out.update(flatten(grads, f"out/{arch}/grads"))
    last, _, cache = jax.jit(lambda p, b: lm.forward(
        p, b, cfg, mesh, prefill=True))(params, batch)
    out[f"out/{arch}/prefill_logits"] = last
    cache = lm.pad_cache(cache, cfg, LM_S + LM_DECODE)
    step = jax.jit(lambda p, c, t, pos: lm.decode_step(p, c, t, pos, cfg,
                                                       mesh))
    for i in range(LM_DECODE):
        pos = jnp.full((LM_B,), LM_S + i, jnp.int32)
        lg, cache = step(params, cache, jnp.asarray(dec[:, i:i + 1]), pos)
        out[f"out/{arch}/decode{i}"] = lg
    prompts = [rs.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in ENGINE_PROMPTS]
    eng = engine.BatchedEngine(cfg, params, batch_slots=len(prompts),
                               s_max=ENGINE_S_MAX, mesh=mesh)
    for uid, pr in enumerate(prompts):
        out[f"in/{arch}/prompt{uid}"] = pr
        eng.submit(engine.Request(uid, [int(t) for t in pr], ENGINE_NEW))
    for req in eng.run():
        out[f"out/{arch}/engine{req.uid}"] = np.array(req.generated)
    return out


def _paths_shapes(tree, prefix=""):
    """(path, shape) of every leaf of a nested dict, sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _paths_shapes(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tuple(tree.shape))]


def _unflat(flat: dict, prefix: str) -> dict:
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = out
        parts = key[len(prefix):].split("/")
        for q in parts[:-1]:
            node = node.setdefault(q, {})
        node[parts[-1]] = jnp.asarray(v)
    return out


def _ulp_moved(params: dict) -> dict:
    """``params`` with the embedding table moved by one ULP, each element
    up or down (``test_torch_lm_families._tol``'s draw)."""
    rs = np.random.RandomState(99)
    table = np.asarray(params["embed"]["table"])
    return dict(params, embed={"table": jnp.asarray(np.nextafter(
        table, np.where(rs.rand(*table.shape) < 0.5, np.inf, -np.inf)
        .astype(np.float32)))})


def part_results(arch, mesh, seed) -> dict:
    """The partitioned step of the reduced config on ``part_inputs``: its
    own ``forward``, ``loss_fn`` (with ``jax.grad``), a prefill and
    ``PART_DECODE`` decode steps, each jitted with ``in_shardings`` from
    ``module.shardings`` (the parameters) and ``shardings_like`` of
    ``batch_axes`` / ``cache_axes`` under the config's overrides (the
    sequence over "model" where they put it there and it divides); one
    AdamW step (``optim.adamw_update``, its train step's update) on the
    gradients; then a ``BatchedEngine`` over the mesh.  For a config
    with mLSTM blocks also the reference's own change (``noise/...``)
    when its embedding table moves by one ULP: the largest change of
    the logits, the gradient's norm, any gradient leaf, the prefill's
    and each decode step's logits."""
    cfg = part_config(arch, configs.ARCHS, base.reduced)
    rules = cfg.sharding_overrides
    s = part_seq(arch, cfg.window)
    specs = lm.param_specs(cfg)
    ops = part_inputs(_paths_shapes(specs), cfg.vocab_size, s, seed,
                      part_patches(cfg))
    params = _unflat(ops, "params/")
    p_sh = module.shardings(specs, mesh, rules)
    tokens, dec = ops["tokens"], ops["decode_tokens"]
    batch = {"tokens": jnp.asarray(tokens)}
    if "patches" in ops:
        batch["patches"] = jnp.asarray(ops["patches"])
    axes = lm.batch_axes(cfg, "train_4k")
    b_sh = module.shardings_like(batch, {k: axes[k] for k in batch}, mesh,
                                 rules)
    # the cache holds the VLM's patches before its tokens
    s += cfg.n_patches
    tag = f"part/{arch}"
    # each step finished before the next is dispatched: one program's
    # collectives in flight at a time
    done = jax.block_until_ready
    fwd = jax.jit(lambda p, b: lm.forward(p, b, cfg, mesh),
                  in_shardings=(p_sh, b_sh))
    loss_grad = jax.jit(jax.value_and_grad(
        lambda p, b: lm.loss_fn(p, b, cfg, mesh), has_aux=True),
        in_shardings=(p_sh, b_sh))
    opt = optim.AdamWConfig()
    adamw = jax.jit(lambda g, p: optim.adamw_update(
        g, optim.adamw_init(p, opt), p, opt))
    prefill = jax.jit(lambda p, b: lm.forward(p, b, cfg, mesh, prefill=True),
                      in_shardings=(p_sh, b_sh))
    dstep = None

    def run(params) -> dict:
        nonlocal dstep
        out = {}
        out[f"out/{tag}/logits"], out[f"out/{tag}/aux"] = done(
            fwd(params, batch))
        (loss, parts), grads = done(loss_grad(params, batch))
        out[f"out/{tag}/loss"], out[f"out/{tag}/ce"] = loss, parts["ce"]
        out.update(flatten(grads, f"out/{tag}/grads"))
        stepped, _, stats = done(adamw(grads, params))
        out.update(flatten(stepped, f"out/{tag}/stepped"))
        out[f"out/{tag}/grad_norm"] = stats["grad_norm"]
        last, _, cache = done(prefill(params, batch))
        out[f"out/{tag}/prefill_logits"] = last
        cache = lm.pad_cache(cache, cfg, s + PART_PAD)
        c_sh = module.shardings_like(cache, lm.cache_axes(cfg), mesh, rules)
        if dstep is None:
            d_sh = module.shardings_like(
                {"tokens": dec[:, :1], "pos": dec[:, 0]},
                {"tokens": ("batch", None), "pos": ("batch",)}, mesh, rules)
            dstep = jax.jit(lambda p, c, t, pos: lm.decode_step(
                p, c, t, pos, cfg, mesh), in_shardings=(
                    p_sh, c_sh, d_sh["tokens"], d_sh["pos"]))
        for i in range(PART_DECODE):
            pos = jnp.full((PART_B,), s + i, jnp.int32)
            lg, cache = done(dstep(params, jax.device_put(cache, c_sh),
                                   jnp.asarray(dec[:, i:i + 1]), pos))
            out[f"out/{tag}/decode{i}"] = lg
        return out

    out = run(params)
    if "mlstm" in cfg.pattern:
        moved = run(_ulp_moved(params))

        def change(key):
            return np.float64(np.abs(np.asarray(moved[key], np.float64)
                                     - np.asarray(out[key])).max())
        for key in ["logits", "grad_norm", "prefill_logits"] + [
                f"decode{i}" for i in range(PART_DECODE)]:
            out[f"out/{tag}/noise/{key}"] = change(f"out/{tag}/{key}")
        out[f"out/{tag}/noise/grads"] = max(
            change(k) for k in out if k.startswith(f"out/{tag}/grads/"))
    eng = engine.BatchedEngine(cfg, params, batch_slots=PART_SLOTS,
                               s_max=PART_S_MAX, mesh=mesh)
    for uid in range(len(PART_PROMPTS)):
        eng.submit(engine.Request(uid, [int(t) for t in ops[f"prompt{uid}"]],
                                  PART_NEW))
    for req in eng.run():
        out[f"out/{tag}/engine{req.uid}"] = np.array(req.generated)
    return out


def main_part(path: str) -> None:
    mesh = compat.make_mesh((2, TP), ("data", "model"))
    res = {}
    for i, arch in enumerate(PART_ARCHS):
        res.update(part_results(arch, mesh, PART_SEED + i))
    np.savez(path, **{k: np.asarray(v) for k, v in res.items()})


def main(path: str) -> None:
    mesh = compat.make_mesh((2, TP), ("data", "model"))
    rs = np.random.RandomState(0)
    p, xs = moe_inputs(rs)
    res = {**flatten(p, "in/moe"), "in/x8": xs[S], "in/x6": xs[6]}
    for name, kind, cf, s, kw in CASES:
        y, aux = jax.jit(lambda p, x: run_path(kind, p, x, mesh, cf, kw))(
            p, xs[s])
        res[f"out/{name}/y"], res[f"out/{name}/aux"] = y, aux
        if kind in ("a2a", "2d") and "wire_dtype" not in kw:
            idx, kept = routing(kind, p, xs[s], mesh, cf, kw)
            res[f"out/{name}/idx"], res[f"out/{name}/kept"] = idx, kept
    res["out/ref/y"], res["out/ref/aux"] = moe.moe_ref(p, xs[S], k=K)
    for kind in ("2d", "a2a"):
        def loss(p, x, kind=kind):
            y, aux = run_path(kind, p, x, mesh, 1.25, {})
            return jnp.sum(y ** 2) + 0.01 * aux
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, xs[S])
        res.update(flatten(gp, f"out/grad_{kind}/p"))
        res[f"out/grad_{kind}/x"] = gx
    for arch in LM_ARCHS:
        res.update(lm_results(arch, mesh, rs))
    np.savez(path, **{k: np.asarray(v) for k, v in res.items()})


if __name__ == "__main__":
    if sys.argv[2:] == ["part"]:
        main_part(sys.argv[1])
    else:
        main(sys.argv[1])
