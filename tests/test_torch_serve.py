"""The port's ``SNNEventEngine`` on the CPU (plain version).

Continuous serving must give every request exactly what a one-shot batch-1
``forward_silicon`` gives, clean and noisy, preempted or not; clean served
requests must match the JAX reference's composed batch-1 forward.  Plus the
lifecycle around it (typed validation, shedding, expiry, the
``terminal_total`` == ledgers invariant, ``energy_report``), the rule that
the port imports neither JAX nor ``repro``, and the rule that entry points
do not fall back to the CPU.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import snn as j_snn
from repro_torch import convert
from repro_torch.configs import base as t_base
from repro_torch.configs import get_config
from repro_torch.core import ima as t_ima
from repro_torch.kernels import ops as t_ops
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import lm as t_lm
from repro_torch.models import snn as t_snn
from repro_torch.nn import module as t_module
from repro_torch.serve import lifecycle
from repro_torch.serve.engine import (BatchedEngine, EventRequest,
                                      SNNEventEngine)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
KW = dict(n_in=32, n_hidden=16, n_classes=3, n_steps=8, k=4)
NOISE = t_ima.IMANoiseModel()


def _setup():
    jcfg = j_snn.SNNConfig(**KW)
    tcfg = t_snn.SNNConfig(**KW)
    p = {k: np.asarray(v) for k, v in
         j_snn.init_params(jcfg, jax.random.PRNGKey(0)).items()}
    return jcfg, tcfg, p, convert.snn_params_from_jax(p, "cpu")


def _traffic(n, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        t = int(rs.randint(5, 15))
        rate = (0.05, 0.2, 0.4)[i % 3]
        out.append(rs.choice([-1.0, 0.0, 1.0],
                             p=[rate / 2, 1 - rate, rate / 2],
                             size=(t, KW["n_in"])).astype(np.float32))
    return out


def _engine(tp, tcfg, **kw):
    base = dict(batch_slots=3, round_steps=4, seed=5, device="cpu")
    base.update(kw)
    return SNNEventEngine(tcfg, tp, **base)


def _assert_one_shot(tp, tcfg, reqs, noise):
    for r in reqs:
        assert r.state == lifecycle.COMPLETED
        logits, tele = t_snn.forward_silicon(
            tp, r.events[None], tcfg, seed=r.seed if noise else 0,
            noise=noise, device="cpu")
        assert torch.equal(logits[0], r.logits), r.uid
        assert float(tele["adc_steps"][0]) == r.adc_steps
        assert float(tele["sops"][0]) == r.sops
        assert 0.0 <= r.skipped_block_ratio <= 1.0


@pytest.mark.parametrize("noise", [None, NOISE], ids=["clean", "noisy"])
def test_continuous_equals_one_shot_batch1(noise):
    _, tcfg, _, tp = _setup()
    eng = _engine(tp, tcfg, noise=noise)
    reqs = [eng.submit(EventRequest(uid=i, events=ev))
            for i, ev in enumerate(_traffic(7))]
    out = eng.run()
    assert [r.uid for r in out] == list(range(7))
    _assert_one_shot(tp, tcfg, reqs, noise)


def test_clean_serving_matches_jax_reference():
    jcfg, tcfg, p, tp = _setup()
    eng = _engine(tp, tcfg)
    reqs = [eng.submit(EventRequest(uid=i, events=ev))
            for i, ev in enumerate(_traffic(4, seed=1))]
    eng.run()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for r in reqs:
        jl, jt = j_snn.forward_silicon(jp, jnp.asarray(r.events)[None], jcfg,
                                       jax.random.PRNGKey(0), fused=False)
        np.testing.assert_allclose(r.logits.numpy(), np.asarray(jl[0]),
                                   rtol=1e-5, atol=1e-6)
        assert r.pred == int(np.argmax(np.asarray(jl[0])))
        assert r.adc_steps == float(jt["adc_steps"][0])
        assert r.sops == float(jt["sops"][0])


@pytest.mark.parametrize("noise", [None, NOISE], ids=["clean", "noisy"])
def test_preempt_unaligned_then_restore_elsewhere(noise):
    """Preempt at step 5 (round_steps 4); the request resumes in another
    slot and still equals its one-shot run bit for bit."""
    _, tcfg, _, tp = _setup()
    eng = _engine(tp, tcfg, noise=noise, batch_slots=2, backoff_rounds=3,
                  pack_by_density=False)
    rs = np.random.RandomState(2)
    # uid 1 ends at step 5 and uid 3 ends before uid 2, so the resumed
    # request lands in slot 1 while slot 0 is still busy
    traffic = [rs.choice([-1.0, 0.0, 1.0], p=[0.1, 0.8, 0.1],
                         size=(t, KW["n_in"])).astype(np.float32)
               for t in (13, 5, 14, 6)]
    reqs = [eng.submit(EventRequest(uid=i, events=ev))
            for i, ev in enumerate(traffic)]
    seen = {}

    def hook(e):
        if "slot" not in seen:
            slot = next(i for i, r in enumerate(e._slot_req)
                        if r is not None and r.uid == 0)
            seen["slot"] = slot
            e.preempt_request(0, at_step=5)
            assert reqs[0]._ckpt.steps_done == 5
        elif "resumed" not in seen:
            for i, r in enumerate(e._slot_req):
                if r is not None and r.uid == 0:
                    seen["resumed"] = i

    eng.run(round_hook=hook)
    assert reqs[0].preemptions == 1 and eng.preemption_count == 1
    assert seen["resumed"] != seen["slot"]
    _assert_one_shot(tp, tcfg, reqs, noise)


def test_checkpoint_roundtrip_and_size():
    _, tcfg, _, tp = _setup()
    state = t_snn.silicon_stream_init(tcfg, 3, device="cpu")
    state = t_snn.silicon_stream_admit(state, np.array([False, True, False]),
                                       np.array([0, 9, 0], np.int32),
                                       np.array([0, 77, 0], np.int32))
    ev = torch.zeros((4, 3, tcfg.n_in))
    ev[:, 1] = torch.from_numpy(_traffic(1)[0][:4])
    state = t_snn.forward_silicon_stream(tp, ev, tcfg, state)
    ck = t_snn.silicon_stream_save(state, 1)
    assert (ck.steps_done, ck.length, ck.seed) == (4, 9, 77)
    assert t_snn.checkpoint_nbytes(ck) == 2 * 4 * tcfg.n_hidden + 8 * 7
    moved = t_snn.silicon_stream_restore(state, 2, ck)
    for a, b in zip(moved, state):
        assert torch.equal(a[2], b[1])


@pytest.mark.parametrize("events,err", [
    (np.zeros((0, 32), np.float32), lifecycle.EmptyEventError),
    (np.zeros((4, 31), np.float32), lifecycle.EventShapeError),
    (np.full((4, 32), np.nan, np.float32), lifecycle.NonFiniteEventError),
    (np.full((4, 32), 0.5, np.float32), lifecycle.NonTernaryEventError),
    (np.array([["a"] * 32] * 4), lifecycle.EventDtypeError)])
def test_typed_validation_errors(events, err):
    _, tcfg, _, tp = _setup()
    eng = _engine(tp, tcfg)
    with pytest.raises(err):
        eng.submit(EventRequest(uid=0, events=events))
    assert not eng.pending


def test_shedding_expiry_and_ledgers():
    _, tcfg, _, tp = _setup()
    eng = _engine(tp, tcfg, max_pending=3)
    traffic = _traffic(6, seed=3)
    reqs = [eng.submit(EventRequest(uid=i, events=ev, priority=i % 2))
            for i, ev in enumerate(traffic[:5])]
    late = eng.submit(EventRequest(uid=9, events=traffic[5], deadline_ms=0.0))
    eng.run()
    # the full queue sheds its lowest-priority, newest request: ``late``
    assert late.state == lifecycle.REJECTED and len(eng.rejected) == 3
    states = {r.uid: r.state for r in reqs + [late]}
    assert all(s in lifecycle.TERMINAL_STATES for s in states.values())
    for state, ledger in (("completed", eng.completed),
                          ("rejected", eng.rejected),
                          ("expired", eng.expired)):
        assert eng.metrics.value("terminal_total", state=state) == \
            len(ledger)
    assert len(eng.completed) + len(eng.rejected) + len(eng.expired) == 6
    rep = eng.energy_report("dvs_gesture")
    for key in ("requests", "mean_adc_steps", "measured_adc_saving",
                "pj_per_step", "pj_per_sop", "mean_skipped_block_ratio",
                "per_request", "latency_ms_p50", "latency_ms_p95",
                "round_ms_p50", "round_ms_p95", "preemptions", "rejected",
                "expired", "deadline_misses"):
        assert key in rep, key
    assert rep["requests"] == len(eng.completed)


def test_expiry_of_queued_request():
    _, tcfg, _, tp = _setup()
    eng = _engine(tp, tcfg, batch_slots=1)
    a = eng.submit(EventRequest(uid=0, events=_traffic(1)[0]))
    b = eng.submit(EventRequest(uid=1, events=_traffic(1)[0],
                                deadline_ms=0.0))
    eng.run()
    assert a.state == lifecycle.COMPLETED and b.state == lifecycle.EXPIRED
    assert eng.metrics.value("expired_total") == 1


def test_legacy_drain_path_completes():
    _, tcfg, _, tp = _setup()
    eng = _engine(tp, tcfg, continuous=False)
    traffic = _traffic(5, seed=4)
    reqs = [eng.submit(EventRequest(uid=i, events=traffic[0]))
            for i in range(3)]
    out = eng.run()
    assert [r.uid for r in out] == [0, 1, 2]
    assert all(r.state == lifecycle.COMPLETED for r in reqs)
    assert all(np.isfinite(r.logits.numpy()).all() for r in reqs)


def test_event_stream_issues_codes():
    _, issues = t_ops.event_stream_issues(np.ones((3, 4)), n_in=4)
    assert issues == []
    _, issues = t_ops.event_stream_issues(np.ones((3, 4)) * 2, n_in=5)
    assert [c for c, _ in issues] == ["shape", "nonternary"]


def test_port_imports_no_jax_and_nothing_of_repro():
    pattern = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro)\b",
                         re.MULTILINE)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for rel in ("core/dendrite.py", "kernels/fused_macro_grad.py",
                "train/silicon.py", "data/events.py", "nn/attention.py",
                "models/lm.py", "kernels/flash_attention.py",
                "nn/kvq.py", "nn/recurrent.py", "train/optim.py",
                "train/train_loop.py", "train/checkpoint.py",
                "train/compression.py", "data/synthetic_lm.py",
                "roofline/analysis.py", "launch/train.py"):
        assert ROOT / "src" / "repro_torch" / rel in files, rel
    for path in files:
        hits = pattern.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_entry_points_do_not_fall_back_to_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    _, tcfg, _, tp = _setup()
    ev = _traffic(1)[0][None]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_snn.forward_silicon(tp, ev, tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SNNEventEngine(tcfg, tp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_snn.silicon_stream_init(tcfg, 2)
    fw = t_snn.pack_fused(tp, tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_ops.fused_macro_seq(torch.zeros((2, 1, tcfg.n_in)), fw.msb, fw.lsb,
                              fw.boundaries, fw.levels, fw.scale,
                              torch.zeros((1, tcfg.n_hidden)))
    lcfg = t_base.reduced(get_config("smollm-135m"))
    specs = t_lm.param_specs(lcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_module.materialize(specs, torch.Generator().manual_seed(0))
    lp = t_module.materialize(specs, torch.Generator().manual_seed(0),
                              device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_lm.init_cache(lcfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedEngine(lcfg, lp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_serve.main(["--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_train.main(["--smoke", "--steps", "1"])
    for arch in ("gemma2-2b", "recurrentgemma-9b", "xlstm-350m"):
        fcfg = t_base.reduced(get_config(arch))
        for kw in ({}, {"kv_quant": "int8"}):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                t_lm.init_cache(dataclasses.replace(fcfg, **kw), 1, 8)
        fp = t_module.materialize(t_lm.param_specs(fcfg),
                                  torch.Generator().manual_seed(0),
                                  device="cpu")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BatchedEngine(fcfg, fp)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_serve.main(["--smoke", "--arch", arch])
    # lm.forward and lm.decode_step run where their tensors are (params
    # from materialize, caches from init_cache); off the CPU the forward's
    # attention launches the kernel, or on ``meta`` (the dry run's tensors
    # without data) runs the kernel's custom op's fake implementation:
    # never the plain version, and no launch
    from repro_torch.kernels import flash_attention, ref

    def plain(*a, **k):
        raise AssertionError("the plain version ran off the CPU")

    monkeypatch.setattr(ref, "flash_attention_ref", plain)
    before = flash_attention.flash_attention_fwd.launches
    meta = t_module.tree_map(lambda t: t.to("meta"), lp)
    logits, _ = t_lm.forward(meta, {"tokens": torch.zeros(
        (1, 4), dtype=torch.long, device="meta")}, lcfg)
    assert logits.is_meta
    assert flash_attention.flash_attention_fwd.launches == before
