"""The port's checkpoints and its training driver on the CPU: the
reference's layout (``step_N/{name}.npz`` with ``jax.tree_util.keystr``
keys, ``meta.json``), atomic saves, keep-N, restores that refuse a
missing leaf or a shape mismatch; a checkpoint the JAX package wrote
after two of its train steps restoring into the port, whose third step
matches the reference's; and a crashed-and-resumed
``python -m repro_torch.launch.train --smoke --device cpu`` equal bit
for bit to an uninterrupted run.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as j_ckpt
from repro.train import optim as j_optim
from repro.train import train_loop as j_loop
from repro_torch.launch import train as t_train
from repro_torch.models import lm as t_lm
from repro_torch.nn import module as t_module
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train import optim as t_optim
from repro_torch.train import train_loop as t_loop
from tests.test_torch_lm_train import (_cfgs, _ocfg, _params, _params_close,
                                       _reference_batches)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree():
    """A dict with a nested dict and a list, f32, bf16 and int32 leaves,
    and an ``AdamWState`` (a ``NamedTuple``) beside it."""
    rs = np.random.RandomState(0)
    params = {"b": {"w": torch.from_numpy(rs.randn(2, 3).astype(np.float32)),
                    "scale": torch.from_numpy(rs.randn(3).astype(np.float32))
                    .to(torch.bfloat16)},
              "a": [torch.arange(4, dtype=torch.int32),
                    torch.from_numpy(rs.randn(5).astype(np.float32))]}
    cfg = t_optim.AdamWConfig(moment_dtype="bfloat16")
    opt = t_optim.adamw_init({"b": params["b"]}, cfg)
    opt = opt._replace(mu={"b": {"w": torch.full((2, 3), 0.25,
                                                 dtype=torch.bfloat16),
                                 "scale": torch.full((3,), -1.5,
                                                     dtype=torch.bfloat16)}},
                       step=torch.tensor(7, dtype=torch.int32))
    return {"params": params, "opt": opt}


def _jax_twin(state):
    """The same trees as JAX arrays (the ``NamedTuple`` as the
    reference's ``AdamWState``)."""
    def conv(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return conv(node)

    opt = state["opt"]
    return {"params": walk(state["params"]),
            "opt": j_optim.AdamWState(conv(opt.step), walk(opt.mu),
                                      walk(opt.nu))}


def _equal_trees(a, b):
    la, lb = list(t_ckpt._paths(a)), list(t_ckpt._paths(b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (key, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), key


def test_save_restore_roundtrip_in_the_reference_layout(tmp_path):
    state = _tree()
    path = t_ckpt.save(str(tmp_path), 5, state, meta={"arch": "x"})
    assert sorted(os.listdir(path)) == ["meta.json", "opt.npz", "params.npz"]
    # the leaf keys are the reference's, for dicts, lists and NamedTuples
    jstate = _jax_twin(state)
    for name in state:
        with np.load(os.path.join(path, f"{name}.npz")) as z:
            assert sorted(z.files) == sorted(j_ckpt._flatten(jstate[name]))
    assert "['b']['w']" in t_ckpt._flatten(state["params"])
    assert ".mu['b']['scale']" in t_ckpt._flatten(state["opt"])
    out, meta = t_ckpt.restore(str(tmp_path), 5, state)
    assert meta == {"step": 5, "arch": "x"}
    _equal_trees(out["params"], state["params"])
    _equal_trees(out["opt"], state["opt"])
    assert isinstance(out["opt"], t_optim.AdamWState)
    assert isinstance(out["params"]["a"], list)


def test_keep_n_gc(tmp_path):
    tree = {"x": torch.zeros(3)}
    for s in range(6):
        t_ckpt.save(str(tmp_path), s, {"s": tree}, keep_n=2)
    assert t_ckpt.all_steps(str(tmp_path)) == [4, 5]
    assert t_ckpt.latest_step(str(tmp_path)) == 5


def test_partial_write_invisible_and_swept(tmp_path):
    """A crashed save's temp dir, and a step dir without ``meta.json``,
    are never listed or restored; the next save sweeps the temp dir."""
    tree = {"x": torch.zeros(3)}
    t_ckpt.save(str(tmp_path), 1, {"s": tree})
    os.makedirs(tmp_path / ".tmp_step_2_junk")
    (tmp_path / ".tmp_step_2_junk" / "s.npz").write_bytes(b"garbage")
    os.makedirs(tmp_path / "step_3")
    assert t_ckpt.all_steps(str(tmp_path)) == [1]
    out, meta = t_ckpt.restore_latest(str(tmp_path), {"s": tree})
    assert meta["step"] == 1
    t_ckpt.save(str(tmp_path), 4, {"s": tree})
    assert not any(n.startswith(".tmp_") for n in os.listdir(tmp_path))
    assert t_ckpt.all_steps(str(tmp_path)) == [1, 4]


def test_failed_save_leaves_no_checkpoint(tmp_path, monkeypatch):
    tree = {"x": torch.ones(3)}
    t_ckpt.save(str(tmp_path), 1, {"s": tree})
    calls = []

    def failing_savez(*args, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise OSError("disk full")
        return np.savez.__wrapped__(*args, **kw)

    failing_savez.__wrapped__ = np.savez
    monkeypatch.setattr(t_ckpt.np, "savez", failing_savez)
    with pytest.raises(OSError, match="disk full"):
        t_ckpt.save(str(tmp_path), 2, {"a": tree, "b": tree})
    assert sorted(os.listdir(tmp_path)) == ["step_1"]
    assert t_ckpt.latest_step(str(tmp_path)) == 1


def test_restore_refuses_missing_leaf_and_shape_mismatch(tmp_path):
    t_ckpt.save(str(tmp_path), 1, {"s": {"x": torch.zeros((2, 3))}})
    with pytest.raises(ValueError, match="shape mismatch"):
        t_ckpt.restore(str(tmp_path), 1, {"s": {"x": torch.zeros((3, 3))}})
    with pytest.raises(KeyError, match="missing leaf"):
        t_ckpt.restore(str(tmp_path), 1, {"s": {"x": torch.zeros((2, 3)),
                                                "y": torch.zeros(1)}})
    assert t_ckpt.restore_latest(str(tmp_path / "none"), {}) is None


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    state = _tree()
    state = {"params": {"b": {"w": state["params"]["b"]["w"]},
                        "a": state["params"]["a"]}}
    t_ckpt.save(str(tmp_path), 3, state)
    jstate = _jax_twin({"params": state["params"], "opt": _tree()["opt"]})
    out, meta = j_ckpt.restore(str(tmp_path), 3,
                               {"params": jstate["params"]})
    assert meta["step"] == 3
    np.testing.assert_array_equal(np.asarray(out["params"]["b"]["w"]),
                                  state["params"]["b"]["w"].numpy())
    np.testing.assert_array_equal(np.asarray(out["params"]["a"][0]),
                                  np.arange(4, dtype=np.int32))


def test_reference_bf16_checkpoint_restores_only_in_the_port(tmp_path):
    """Reference-side failure: the reference writes a bf16 leaf as numpy's
    2-byte void records and its own restore cannot cast them back
    (``ValueError: No cast function available``); the port reads them as
    bf16 bits."""
    state = _tree()
    jstate = _jax_twin(state)
    j_ckpt.save(str(tmp_path), 2, jstate)
    with pytest.raises(ValueError, match="No cast function"):
        j_ckpt.restore(str(tmp_path), 2, jstate)
    out, _ = t_ckpt.restore(str(tmp_path), 2, state)
    _equal_trees(out["params"], state["params"])
    _equal_trees(out["opt"], state["opt"])


def test_reference_checkpoint_continues_in_the_port(tmp_path):
    """Two of the reference's train steps (two microbatches), saved by its
    ``checkpoint.save``; the port restores them into its own templates
    bit for bit, and its third step on the reference's batch matches the
    reference's third step (loss, grad norm and lr within 1e-5, the
    parameters as ``_params_close`` holds them)."""
    jc, tc = _cfgs("smollm-135m")
    jp, _ = _params(jc)
    jo, to = _ocfg()
    jstate = j_optim.adamw_init(jp, jo)
    jstep = jax.jit(j_loop.build_train_step(jc, None, n_micro=2, opt_cfg=jo))
    batches = _reference_batches(jc, 3, 2)
    for batch in batches[:2]:
        jp, jstate, _ = jstep(jp, jstate, batch)
    j_ckpt.save(str(tmp_path), 2, {"params": jp, "opt": jstate},
                meta={"arch": jc.name})
    tmpl = t_module.materialize(t_lm.param_specs(tc),
                                torch.Generator().manual_seed(9),
                                device="cpu")
    restored, meta = t_ckpt.restore_latest(
        str(tmp_path), {"params": tmpl, "opt": t_optim.adamw_init(tmpl, to)})
    assert meta == {"step": 2, "arch": jc.name}
    tp, tstate = restored["params"], restored["opt"]
    assert int(tstate.step) == 2
    for key, leaf in t_ckpt._paths(tp):
        assert np.array_equal(leaf.numpy(), j_ckpt._flatten(jp)[key]), key
    jp, jstate, jm = jstep(jp, jstate, batches[2])
    tp, tstate, tm = t_loop.build_train_step(tc, n_micro=2, opt_cfg=to)(
        tp, tstate, {"tokens": torch.from_numpy(np.array(batches[2]["tokens"]))})
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    assert int(tstate.step) == int(jstate.step) == 3
    _params_close(tp, jp, float(tm["lr"]))


def _train_run(ckpt_dir, metrics, crash_at=-1):
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--smoke", "--device", "cpu", "--steps", "6",
           "--global-batch", "4", "--seq-len", "32", "--n-micro", "2",
           "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "2",
           "--metrics-out", str(metrics), "--crash-at-step", str(crash_at)]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=300)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_crash_and_resume_bitwise(tmp_path):
    """An uninterrupted run of 6 steps against one that exits hard at step
    3 (after the checkpoint of step 2) and is started again: the resumed
    run starts at step 2, and its losses and its final parameters and
    AdamW state are the uninterrupted run's, bit for bit."""
    gold = _train_run(tmp_path / "gold", tmp_path / "gold.json")
    assert gold.returncode == 0, gold.stderr[-2000:]
    crashed = _train_run(tmp_path / "ft", tmp_path / "ft1.json", crash_at=3)
    assert crashed.returncode == 42, crashed.stderr[-2000:]
    assert "[fault-injection] hard exit at step 3" in crashed.stdout
    assert t_ckpt.latest_step(str(tmp_path / "ft")) == 2
    resumed = _train_run(tmp_path / "ft", tmp_path / "ft2.json")
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert "[resume] restored step 2" in resumed.stdout
    gold_h = json.loads((tmp_path / "gold.json").read_text())
    res_h = json.loads((tmp_path / "ft2.json").read_text())
    assert [h["step"] for h in res_h] == [2, 3, 4, 5]
    gold_loss = {h["step"]: h["loss"] for h in gold_h}
    assert all(h["loss"] == gold_loss[h["step"]] for h in res_h)
    assert gold_h[-1]["loss"] < gold_h[0]["loss"]
    for name in ("params.npz", "opt.npz"):
        a = _npz(tmp_path / "gold" / "step_6" / name)
        b = _npz(tmp_path / "ft" / "step_6" / name)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), (name, k)


def test_train_main_in_process_restores_determinism_flag(tmp_path):
    assert not torch.are_deterministic_algorithms_enabled()
    hist = t_train.main(["--smoke", "--device", "cpu", "--steps", "2",
                         "--global-batch", "2", "--seq-len", "16",
                         "--ckpt-dir", str(tmp_path), "--ckpt-every", "5"])
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) and h["sec"] > 0 for h in hist)
    assert not torch.are_deterministic_algorithms_enabled()
    assert t_ckpt.all_steps(str(tmp_path)) == [2]
