"""The port's stacked KWN path (L layers in one launch) against the JAX package.

The JAX stacked Pallas kernel runs on jax 0.9 in interpret mode, so the
port's plain version is held to it directly and to the composed oracle
``repro.kernels.ref.fused_macro_multi_seq_ref``: membranes, spikes, mask,
ADC steps, row spike counts and the occupancy counters bit for bit, clean
and with the counter noise, at a two-layer shape, a ragged plan (K=300
and a deep layer wider than one K tile), three layers, and three
512-column layers.  Also the
config checks, packing and plans, ``forward_silicon`` against JAX's
``forward_silicon(fused="seq")`` (with JAX's per-layer seeds), and stacks
in the serving engine (drain path only).  The CUDA kernel is held to the
plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ima as j_ima
from repro.core import macro as j_macro
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.models import snn as j_snn
from repro_torch import convert
from repro_torch.core import ima as t_ima
from repro_torch.core import macro as t_macro
from repro_torch.kernels import fused_macro as t_fused
from repro_torch.kernels import ops as t_ops
from repro_torch.models import snn as t_snn
from repro_torch.serve import lifecycle
from repro_torch.serve.engine import EventRequest, SNNEventEngine

torch.set_num_threads(1)

NOISE = j_ima.IMANoiseModel()
T_NOISE = t_ima.IMANoiseModel()

# (T, M, K, widths, ks): two layers; a ragged plan (K=300 pads to two K
# tiles, and the deep layer's 300 inputs make a 256 + 44 ragged K tile);
# three layers of ragged widths
SHAPES = [(5, 9, 96, (64, 48), (6, 5)), (4, 13, 300, (300, 20), (12, 3)),
          (4, 11, 96, (40, 200, 20), (4, 12, 3))]


def _case(shape, seed=0):
    t, m, kdim, widths, ks = shape
    rs = np.random.RandomState(seed)
    mcfg = j_macro.CIMMacroConfig(code_bits=5, mac_range=24.0,
                                  ima_noise=NOISE)
    fan_ins = (kdim,) + widths[:-1]
    stack = j_macro.pack_kwn_stack(
        [jnp.asarray(rs.randint(-3, 4, (a, b)).astype(np.float32))
         for a, b in zip(fan_ins, widths)],
        [jnp.asarray(rs.uniform(0.01, 0.1, b).astype(np.float32))
         for b in widths], mcfg)
    x = rs.choice([-1.0, 0.0, 1.0], p=[0.05, 0.9, 0.05],
                  size=(t, m, kdim)).astype(np.float32)
    x[1::3] = 0.0                         # quiet steps: skipped blocks
    vs = [rs.uniform(-1.0, 1.2, (m, w)).astype(np.float32) for w in widths]
    nz = [rs.choice([-0.05, 0.05], size=(t, m, w)).astype(np.float32)
          for w in widths]
    return stack, mcfg, x, vs, nz, ks


def _planes(stack):
    return [tuple(np.asarray(a) for a in (fw.msb, fw.lsb, fw.boundaries,
                                          fw.levels, fw.scale))
            for fw in stack]


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_stack_equals_jax_kernel_and_oracle(shape, noisy):
    stack, mcfg, x, vs, nz, ks = _case(shape)
    kw = dict(ks=ks, drive_gain=0.25)
    if noisy:
        kw.update(ima_noise=j_macro.fused_kernel_noise(stack[0], mcfg),
                  snl_amp=0.05, seeds=[11, 22, 33][:len(ks)],
                  step_offset=3)
    planes = _planes(stack)
    jnz = None if noisy else [jnp.asarray(a) for a in nz]
    want = j_ops.fused_macro_multi_seq(jnp.asarray(x), planes,
                                       [jnp.asarray(v) for v in vs], jnz,
                                       **kw)
    got = t_ops.fused_macro_multi_seq(
        torch.from_numpy(x), [tuple(torch.from_numpy(a) for a in p)
                              for p in planes],
        [torch.from_numpy(v) for v in vs],
        None if noisy else [torch.from_numpy(a) for a in nz],
        device="cpu", **kw)
    for name in ("v_outs", "steps", "spike_counts", "occupancy"):
        for li, (a, b) in enumerate(zip(getattr(want, name),
                                        getattr(got, name))):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"{name}[{li}]")
    np.testing.assert_array_equal(np.asarray(want.spikes), got.spikes)
    np.testing.assert_array_equal(np.asarray(want.mask), got.mask)
    assert want.total_blocks == got.total_blocks
    # the composed oracle: layer l's spike stack is layer l+1's input
    rkw = {k: v for k, v in kw.items() if k != "seeds"}
    v_fins, spk, mask, steps, counts = j_ref.fused_macro_multi_seq_ref(
        jnp.asarray(x), planes, [jnp.asarray(v) for v in vs], jnz,
        seeds=kw.get("seeds"), **rkw)
    for li in range(len(ks)):
        np.testing.assert_array_equal(np.asarray(v_fins[li]),
                                      got.v_outs[li].numpy())
        np.testing.assert_array_equal(np.asarray(steps[li])[..., 0],
                                      got.steps[li].numpy())
        np.testing.assert_array_equal(np.asarray(counts[li]),
                                      got.spike_counts[li].numpy())
    np.testing.assert_array_equal(np.asarray(spk), got.spikes.numpy())
    assert got.spikes.sum() > 0
    assert 0 < sum(int(o.sum()) for o in got.occupancy) < got.total_blocks


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
def test_wide_stack_equals_jax_kernel(noisy):
    """Three 512-column layers, which the port once refused (3 x 16
    register columns a lane in its first stacked kernel), through the
    plain version against JAX's stacked Pallas kernel, bit for bit."""
    shape = (3, 8, 64, (512, 512, 512), (4, 4, 4))
    stack, mcfg, x, vs, nz, ks = _case(shape, seed=3)
    kw = dict(ks=ks, drive_gain=0.25)
    if noisy:
        kw.update(ima_noise=j_macro.fused_kernel_noise(stack[0], mcfg),
                  snl_amp=0.05, seeds=[7, 8, 9], step_offset=2)
    planes = _planes(stack)
    want = j_ops.fused_macro_multi_seq(
        jnp.asarray(x), planes, [jnp.asarray(v) for v in vs],
        None if noisy else [jnp.asarray(a) for a in nz], **kw)
    got = t_ops.fused_macro_multi_seq(
        torch.from_numpy(x), [tuple(torch.from_numpy(a) for a in p)
                              for p in planes],
        [torch.from_numpy(v) for v in vs],
        None if noisy else [torch.from_numpy(a) for a in nz],
        device="cpu", **kw)
    for name in ("v_outs", "steps", "spike_counts", "occupancy"):
        for li, (a, b) in enumerate(zip(getattr(want, name),
                                        getattr(got, name))):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"{name}[{li}]")
    np.testing.assert_array_equal(np.asarray(want.spikes), got.spikes)
    np.testing.assert_array_equal(np.asarray(want.mask), got.mask)
    assert sum(float(c.sum()) for c in got.spike_counts[:-1]) > 0


def test_stack_deeper_than_max_layers_raises():
    """The stacked kernel's parameter struct holds MAX_LAYERS layers: one
    more raises on every device, without a fallback."""
    n_layers = t_fused.MAX_LAYERS + 1
    plane = lambda k, n: (torch.zeros((k, n), dtype=torch.int8),
                          torch.zeros((k, n), dtype=torch.int8),
                          torch.zeros(31), torch.zeros(32), torch.ones(n))
    stack = [plane(64, 16)] + [plane(16, 16)] * (n_layers - 1)
    with pytest.raises(ValueError, match=f"1..{t_fused.MAX_LAYERS} layers"):
        t_ops.fused_macro_multi_seq(torch.zeros((2, 4, 64)), stack,
                                    [torch.zeros((4, 16))] * n_layers, None,
                                    ks=(4,) * n_layers, device="cpu")


def test_cpu_tensors_never_launch_the_stack_kernel():
    stack, _, x, vs, nz, ks = _case(SHAPES[0])
    before = t_fused.fused_macro_multi_seq.launches
    t_ops.fused_macro_multi_seq(
        torch.from_numpy(x), [tuple(torch.from_numpy(a) for a in p)
                              for p in _planes(stack)],
        [torch.from_numpy(v) for v in vs],
        [torch.from_numpy(a) for a in nz], ks=ks, device="cpu")
    assert t_fused.fused_macro_multi_seq.launches == before


def test_stack_config_checks():
    cfg = t_snn.SNNConfig(n_in=32, hidden_layers=[16, 8], k_layers=[3, 2])
    assert cfg.hidden_layers == (16, 8) and cfg.n_hidden == 8
    assert cfg.layer_widths == (16, 8) and cfg.layer_k == (3, 2)
    assert t_snn.SNNConfig(n_in=4, n_hidden=6).layer_widths == (6,)
    with pytest.raises(ValueError, match="non-empty"):
        t_snn.SNNConfig(n_in=32, hidden_layers=())
    with pytest.raises(ValueError, match="KWN-only"):
        t_snn.SNNConfig(n_in=32, mode="nld", hidden_layers=(8, 8))
    with pytest.raises(ValueError, match="k_layers"):
        t_snn.SNNConfig(n_in=32, hidden_layers=(8, 8), k_layers=(2,))
    for kw in (dict(n_in=32, hidden_layers=(16, 8), k_layers=(3, 2)),
               dict(n_in=32, hidden_layers=(16,))):
        j, t = j_snn.SNNConfig(**kw), t_snn.SNNConfig(**kw)
        assert (j.n_hidden, j.layer_widths, j.layer_k) == \
            (t.n_hidden, t.layer_widths, t.layer_k)


def test_pack_and_plan_stack_match_reference():
    rs = np.random.RandomState(6)
    widths, fan_ins = (40, 24), (70, 40)
    w_ints = [rs.randint(-3, 4, (a, b)).astype(np.float32)
              for a, b in zip(fan_ins, widths)]
    scales = [rs.uniform(0.01, 0.1, b).astype(np.float32) for b in widths]
    jcfg = j_macro.CIMMacroConfig(code_bits=5, mac_range=24.0)
    tcfg = t_macro.CIMMacroConfig(code_bits=5, mac_range=24.0)
    js = j_macro.pack_kwn_stack([jnp.asarray(w) for w in w_ints],
                                [jnp.asarray(s) for s in scales], jcfg)
    ts = t_macro.pack_kwn_stack([torch.from_numpy(w) for w in w_ints],
                                [torch.from_numpy(s) for s in scales], tcfg)
    for jw, tw in zip(js, ts):
        for name in ("msb", "lsb", "scale", "boundaries", "levels"):
            np.testing.assert_array_equal(np.asarray(getattr(jw, name)),
                                          getattr(tw, name).numpy())
    for (jp, _), tp in zip(j_macro.plan_fused_stack(5, js, 7),
                           t_macro.plan_fused_stack(5, ts, 7)):
        assert tuple(jp) == tuple(tp)
    with pytest.raises(ValueError, match="chain"):
        t_macro.pack_kwn_stack([torch.from_numpy(w_ints[1]),
                                torch.from_numpy(w_ints[1])],
                               [torch.from_numpy(scales[1])] * 2, tcfg)


# --- the model: forward_silicon and serving --------------------------------

KW = dict(n_in=96, n_classes=5, n_steps=12, hidden_layers=(64, 48),
          k_layers=(6, 5))


def _setup(seed=0, **kw):
    cfg_kw = dict(KW, **kw)
    jcfg = j_snn.SNNConfig(**cfg_kw)
    tcfg = t_snn.SNNConfig(**cfg_kw)
    p = j_snn.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, p, convert.snn_params_from_jax(p, "cpu")


def _events(b, t, n_in, seed=0, rate=0.12):
    rs = np.random.RandomState(seed)
    return rs.choice([-1.0, 0.0, 1.0], p=[rate / 2, 1 - rate, rate / 2],
                     size=(b, t, n_in)).astype(np.float32)


@pytest.mark.parametrize("b,t,noisy", [(1, 12, False), (4, 9, False),
                                       (3, 10, True), (1, 8, True)])
def test_stack_forward_matches_jax(b, t, noisy):
    """``forward_silicon`` on a stack == JAX ``forward_silicon(fused="seq")``
    (the stacked Pallas kernel in interpret mode), noisy with JAX's
    per-layer seed words."""
    jcfg, tcfg, p, tp = _setup()
    ev = _events(b, t, jcfg.n_in, seed=t)
    ev[:, ::3] = 0.0                      # quiet steps: skipped blocks
    key = jax.random.PRNGKey(17)
    jl, jt = j_snn.forward_silicon(p, jnp.asarray(ev), jcfg, key,
                                   noise=NOISE if noisy else None,
                                   fused="seq")
    seeds = None
    if noisy:
        seeds = [int(s) for s in np.asarray(
            j_snn._noise_seeds(key, len(jcfg.layer_widths)))]
    tl, tt = t_snn.forward_silicon(tp, ev, tcfg, seeds=seeds,
                                   noise=T_NOISE if noisy else None,
                                   device="cpu")
    for key_ in ("adc_steps", "lif_updates", "sops", "skipped_block_ratio"):
        np.testing.assert_array_equal(np.asarray(jt[key_]),
                                      tt[key_].numpy(), err_msg=key_)
    assert 0.0 < float(tt["skipped_block_ratio"][0]) < 1.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.argmax(np.asarray(jl), -1))


def test_noisy_stack_seeds_default_from_seed():
    _, tcfg, _, tp = _setup()
    ev = _events(2, 6, tcfg.n_in, seed=1, rate=0.3)
    seeds = t_snn.layer_seeds(123, 2)
    assert len(set(seeds)) == 2 and all(0 <= s < 2 ** 31 for s in seeds)
    a = t_snn.forward_silicon(tp, ev, tcfg, seed=123, noise=T_NOISE,
                              device="cpu")
    b = t_snn.forward_silicon(tp, ev, tcfg, seeds=seeds, noise=T_NOISE,
                              device="cpu")
    assert all(torch.equal(a[1][k], b[1][k]) for k in a[1])
    assert torch.equal(a[0], b[0])


def test_stack_init_params_shapes():
    _, tcfg, _, _ = _setup()
    p = t_snn.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert [tuple(w.shape) for w in p["w_hid"]] == [(96, 64), (64, 48)]
    assert tuple(p["w_out"].shape) == (48, 5)
    with pytest.raises(ValueError, match="one array per layer"):
        t_snn.forward_silicon(dict(p, w_hid=p["w_hid"][0]),
                              _events(1, 3, 96), tcfg, device="cpu")


def test_engine_serves_stacks_on_the_drain_path():
    _, tcfg, _, tp = _setup()
    with pytest.raises(ValueError, match="single-layer config"):
        SNNEventEngine(tcfg, tp, continuous=True, device="cpu")
    eng = SNNEventEngine(tcfg, tp, batch_slots=3, seed=2,
                         pack_by_density=False, device="cpu")
    assert not eng.continuous
    traffic = list(_events(3, 6, tcfg.n_in, seed=8))
    reqs = [eng.submit(EventRequest(uid=i, events=ev))
            for i, ev in enumerate(traffic)]
    out = eng.run()
    assert [r.uid for r in out] == [0, 1, 2]
    assert all(r.state == lifecycle.COMPLETED for r in reqs)
    assert eng.energy_report("dvs_gesture")["requests"] == 3
    # one drain batch of the three streams, as the engine stacks them
    logits, tele = t_snn.forward_silicon(tp, np.stack(traffic), tcfg,
                                         device="cpu")
    for i, r in enumerate(reqs):
        assert torch.equal(r.logits, logits[i])
        assert r.adc_steps == float(tele["adc_steps"][i])
        assert r.sops == float(tele["sops"][i])
        assert r.skipped_block_ratio == float(tele["skipped_block_ratio"][i])
    with pytest.raises(ValueError, match="single-layer only"):
        t_snn.forward_silicon_stream(
            tp, torch.zeros((2, 3, tcfg.n_in)), tcfg,
            t_snn.silicon_stream_init(tcfg, 3, device="cpu"))
