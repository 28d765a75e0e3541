"""The port's NLD mode (nonlinear dendrites) against the JAX package on the CPU.

The single-layer Pallas launches do not run on jax 0.9, so the NLD head is
held to the oracle ``repro.kernels.ref.fused_macro_seq_ref(mode="nld")``:
MAC, membrane, spikes, mask and ADC steps bit for bit, clean and with the
counter noise, at the DVS-Gesture width cut to a few rows, at a ragged
shape and at J=3 with column padding.  Also the activation codebooks,
``pack_nld_weights``, the NLD tile plan, ``forward_silicon`` against a JAX
harness built from the same oracle, and continuous NLD serving against
one-shot batch-1 runs.  The CUDA kernel is held to the plain version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dendrite as j_dend
from repro.core import ima as j_ima
from repro.core import lif as j_lif
from repro.core import macro as j_macro
from repro.core import ternary as j_ternary
from repro.kernels import fused_macro as j_fused
from repro.kernels import ref as j_ref
from repro.models import snn as j_snn
from repro_torch import convert
from repro_torch.core import dendrite as t_dend
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


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("activation", ["quadratic", "relu", "sigmoid4"])
def test_activation_codebooks_bit_for_bit(activation):
    """Levels and boundaries equal the reference's for 2..128 codes;
    ``sigmoid4`` needs XLA's f32 exp (``ima._expf``), which is pinned here
    too."""
    for bits in range(1, 8):
        for lo, hi in ((-4.0, 4.0), (-1.0, 3.0), (-24.0, 24.0)):
            want = j_ima.activation_codebook(
                bits, j_ima.DENDRITE_ACTIVATIONS[activation], lo, hi)
            got = t_ima.activation_codebook(
                bits, t_ima.DENDRITE_ACTIVATIONS[activation], lo, hi)
            np.testing.assert_array_equal(_bits(want.levels),
                                          _bits(got.levels.numpy()))
            np.testing.assert_array_equal(_bits(want.boundaries),
                                          _bits(got.boundaries.numpy()))
            assert (got.in_lo, got.in_hi) == (want.in_lo, want.in_hi)


def test_expf_matches_reference():
    """XLA's f32 exp, on the arguments the codebooks and a wide sweep use."""
    rs = np.random.RandomState(0)
    x = np.concatenate([rs.uniform(-30, 30, 20000),
                        rs.uniform(-1, 1, 20000),
                        np.linspace(-88, 88, 4001)]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(jnp.asarray(x)))
    np.testing.assert_array_equal(_bits(want), _bits(t_ima._expf(x)))


def _dend(kdim, n, n_branches, seed=1):
    return j_dend.dendrite_init(jax.random.PRNGKey(seed), kdim, n,
                                n_branches)


@pytest.mark.parametrize("n_branches,activation",
                         [(2, "relu"), (3, "quadratic"), (2, "sigmoid4")])
def test_pack_nld_weights_matches_reference(n_branches, activation):
    dp = _dend(70, 24, n_branches)
    jcfg = j_macro.CIMMacroConfig(code_bits=5, mac_range=4.0,
                                  ima_noise=NOISE)
    tcfg = t_macro.CIMMacroConfig(code_bits=5, mac_range=4.0,
                                  ima_noise=T_NOISE)
    jw = j_macro.pack_nld_weights(dp, jcfg, activation=activation)
    tp = convert.snn_params_from_jax({"dend": dp, "w_out": np.zeros(1)},
                                     "cpu")
    tw = t_macro.pack_nld_weights(tp["dend"], tcfg, activation)
    carried = convert.fused_weights_from_jax(jw, "cpu")
    for name in ("msb", "lsb", "scale", "boundaries", "levels", "w_dend"):
        want = np.asarray(getattr(jw, name))
        assert getattr(tw, name).dtype == getattr(carried, name).dtype
        np.testing.assert_array_equal(want, getattr(tw, name).numpy(),
                                      err_msg=name)
        np.testing.assert_array_equal(want, getattr(carried, name).numpy(),
                                      err_msg=name)
    assert tw.mode == carried.mode == "nld"
    assert tuple(j_macro.fused_kernel_noise(jw, jcfg)) == \
        tuple(t_macro.fused_kernel_noise(tw, tcfg))


@pytest.mark.parametrize("n_branches", [2, 3, 5])
def test_plan_tiles_nld_matches_reference(n_branches):
    for m in (1, 8, 37, 130):
        for kdim in (96, 300, 512):
            for n in (20, 40, 64, 128, 129, 300):
                nc = n_branches * n
                want = j_fused.plan_tiles(m, kdim, nc, n, 8, mode="nld",
                                          n_branches=n_branches,
                                          use_cache=False)
                got = t_fused.plan_tiles(m, kdim, nc, n, 8, mode="nld",
                                         n_branches=n_branches)
                assert tuple(want) == tuple(got), (m, kdim, n)


# (T, M, K, N, J, activation): the DVS-Gesture width cut to a few rows, a
# ragged shape (N not a multiple of 32, K=300), and J=3 with column padding
# (J*N = 150 > 128: each branch is padded to 128)
SHAPES = [(4, 3, 512, 128, 2, "relu"), (5, 13, 300, 40, 2, "quadratic"),
          (3, 5, 96, 50, 3, "sigmoid4")]


def _case(shape, seed=0):
    t, m, kdim, n, n_branches, activation = shape
    rs = np.random.RandomState(seed)
    mcfg = j_macro.CIMMacroConfig(code_bits=5, mac_range=4.0,
                                  ima_noise=NOISE)
    fw = j_macro.pack_nld_weights(_dend(kdim, n, n_branches, seed + 1),
                                  mcfg, activation=activation)
    x = rs.choice([-1.0, 0.0, 1.0], p=[0.1, 0.8, 0.1],
                  size=(t, m, kdim)).astype(np.float32)
    v0 = rs.uniform(-1.0, 1.2, (m, n)).astype(np.float32)
    return fw, mcfg, x, v0


def _oracle(fw, x, v0, **kw):
    out = j_ref.fused_macro_seq_ref(jnp.asarray(x), fw.msb, fw.lsb,
                                    fw.boundaries, fw.levels, fw.scale,
                                    jnp.asarray(v0), None, fw.w_dend,
                                    mode="nld", drive_gain=0.25, **kw)
    mac, v, spk, mask, steps = out
    return [np.asarray(a) for a in (mac, v, spk, mask, steps[..., 0])]


def _port(fw, x, v0, **kw):
    tw = convert.fused_weights_from_jax(fw, device="cpu")
    out = t_ops.fused_macro_seq(
        torch.from_numpy(x), tw.msb, tw.lsb, tw.boundaries, tw.levels,
        tw.scale, torch.from_numpy(v0), None, tw.w_dend, mode="nld",
        drive_gain=0.25, device="cpu", **kw)
    return [a.numpy() for a in out]


def _assert_all_equal(want, got):
    for name, a, b in zip(("mac", "v_out", "spikes", "mask", "steps"),
                          want, got):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(_bits(a) if a.dtype == np.float32
                                      else a,
                                      _bits(b) if b.dtype == np.float32
                                      else b, err_msg=name)


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_nld_equals_oracle(shape, noisy):
    fw, mcfg, x, v0 = _case(shape)
    kw = {}
    if noisy:
        kw = dict(ima_noise=j_macro.fused_kernel_noise(fw, mcfg),
                  seed=424242, step_offset=5)
    want = _oracle(fw, x, v0, **kw)
    _assert_all_equal(want, _port(fw, x, v0, **kw))
    assert want[2].sum() > 0                      # the soma fires
    assert (want[3] == 1).all()


def test_noise_moves_codes():
    """The counter noise reaches the NLD ramp: clean and noisy differ."""
    fw, mcfg, x, v0 = _case(SHAPES[0])
    clean = _port(fw, x, v0)
    noisy = _port(fw, x, v0, ima_noise=j_macro.fused_kernel_noise(fw, mcfg),
                  seed=3)
    assert not np.array_equal(clean[1], noisy[1])


def test_plain_nld_row_ctl_replays_batch1_streams():
    """Each row with ``[seed, offset, 0]`` equals a batch-1 oracle run."""
    fw, mcfg, x, v0 = _case((4, 5, 96, 50, 3, "relu"), seed=2)
    kn = j_macro.fused_kernel_noise(fw, mcfg)
    seeds, offs = [11, 22, 33, 44, 55], [0, 3, 8, 1, 13]
    rc = np.stack([seeds, offs, [0] * 5], -1).astype(np.int32)
    got = _port(fw, x, v0, ima_noise=kn, row_ctl=torch.from_numpy(rc))
    for i in range(5):
        want = _oracle(fw, x[:, i:i + 1], v0[i:i + 1], ima_noise=kn,
                       seed=seeds[i], step_offset=offs[i])
        mac, v, spk, mask, steps = got
        _assert_all_equal(want, [mac[:, i:i + 1], v[i:i + 1],
                                 spk[:, i:i + 1], mask[:, i:i + 1],
                                 steps[:, i:i + 1]])


def test_cpu_tensors_never_launch_the_nld_kernel():
    fw, _, x, v0 = _case(SHAPES[1])
    before = t_fused.fused_macro_seq_nld.launches
    _port(fw, x, v0)
    assert t_fused.fused_macro_seq_nld.launches == before


def test_dendrite_mac_matches_reference():
    """The plain Eq. 2 drive (float weights, quantized NL-IMA ramp)."""
    dp = _dend(40, 12, 3)
    cb = j_ima.activation_codebook(5, j_ima.relu, -4.0, 4.0)
    rs = np.random.RandomState(4)
    s = rs.choice([-1.0, 0.0, 1.0], p=[0.2, 0.6, 0.2],
                  size=(6, 40)).astype(np.float32)
    want = j_dend.dendrite_mac(dp, jnp.asarray(s), nl_cb=cb, quantize=True)
    tp = convert.snn_params_from_jax({"dend": dp, "w_out": np.zeros(1)},
                                     "cpu")
    got = t_dend.dendrite_mac(tp["dend"], torch.from_numpy(s),
                              t_ima.activation_codebook(5, t_ima.relu,
                                                        -4.0, 4.0))
    # float einsums: XLA and PyTorch sum the branches and inputs in
    # different orders, so equal to a few f32 ULPs of the drive
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_dendrite_init_is_seeded_and_sparse():
    a = t_dend.dendrite_init(torch.Generator().manual_seed(5), 64, 16, 2,
                             device="cpu")
    b = t_dend.dendrite_init(torch.Generator().manual_seed(5), 64, 16, 2,
                             device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a.w_syn.shape == a.mask.shape == (2, 64, 16)
    assert a.w_dend.shape == (2, 16)
    assert torch.all(a.w_syn[a.mask == 0] == 0)
    assert 0.35 < float(a.mask.mean()) < 0.65     # fan-in 1/J


# --- the model: forward_silicon and serving --------------------------------

KW = dict(n_in=64, n_hidden=24, n_classes=4, n_steps=10, mode="nld",
          n_branches=2, activation="relu", dend_range=4.0)


def _setup(seed=0, **kw):
    cfg_kw = dict(KW, **kw)
    jcfg = j_snn.SNNConfig(**cfg_kw)
    tcfg = t_snn.SNNConfig(**cfg_kw)
    p = j_snn.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, p, convert.snn_params_from_jax(p, "cpu")


def _events(b, t, n_in, seed=0, rate=0.15):
    rs = np.random.RandomState(seed)
    return rs.choice([-1.0, 0.0, 1.0], p=[rate / 2, 1 - rate, rate / 2],
                     size=(b, t, n_in)).astype(np.float32)


def _jax_harness(p, ev, cfg, seed, noise):
    """What JAX ``forward_silicon(fused="seq")`` computes in NLD mode, with
    the oracle in place of the Pallas launch: ``pack_nld_weights``, the
    oracle over the whole sequence (a zero SNL tensor when clean), the
    left fold of the telemetry and the readout."""
    mcfg = j_macro.CIMMacroConfig(code_bits=cfg.code_bits,
                                  mac_range=cfg.dend_range, ima_noise=noise)
    fw = j_snn._pack_fused(p, cfg, "nld", mcfg)
    kn = j_macro.fused_kernel_noise(fw, mcfg)
    b, t = ev.shape[0], ev.shape[1]
    ev_t = j_ternary.ternary_input_encode(jnp.moveaxis(jnp.asarray(ev), 1, 0))
    nz = None if noise is not None else jnp.zeros((t, b, cfg.n_hidden))
    _, _, spk, _, steps = j_ref.fused_macro_seq_ref(
        ev_t, fw.msb, fw.lsb, fw.boundaries, fw.levels, fw.scale,
        jnp.zeros((b, cfg.n_hidden)), nz, fw.w_dend, mode="nld", k=cfg.k,
        drive_gain=cfg.drive_gain, beta=cfg.beta, v_th1=cfg.v_th1,
        v_th2=cfg.v_th2, v_reset=0.0, v_lim=j_lif.vmem_limit(12),
        use_snl=False, ima_noise=kn, snl_amp=0.0, seed=seed)
    counts = jnp.sum(spk, 0)
    logits = (counts / t) @ p["w_out"]
    tele = {"adc_steps": jnp.sum(steps[..., 0].astype(jnp.float32), 0) / t,
            "lif_updates": jnp.full((b,), float(cfg.n_hidden * t)) / t,
            "sops": jnp.sum(jnp.sum(jnp.abs(ev_t), -1), 0)
            * cfg.n_hidden / t,
            "skipped_block_ratio": j_snn._skipped_block_ratio(
                jnp.asarray(ev), fw, cfg)}
    return (np.asarray(logits), np.asarray(counts),
            {k: np.asarray(v) for k, v in tele.items()})


@pytest.mark.parametrize("b,t,noisy", [(1, 10, False), (4, 9, False),
                                       (3, 12, True), (1, 7, True)])
def test_nld_forward_matches_jax_harness(b, t, noisy):
    jcfg, tcfg, p, tp = _setup()
    ev = _events(b, t, jcfg.n_in, seed=t)
    ev[:, ::3, :32] = 0.0                 # some quiet activity blocks
    seed = 987654 if noisy else 0
    jl, jcounts, jt = _jax_harness(p, ev, jcfg, seed,
                                   NOISE if noisy else None)
    tl, tt = t_snn.forward_silicon(tp, ev, tcfg, seed=seed,
                                   noise=T_NOISE if noisy else None,
                                   device="cpu")
    for key, want in jt.items():
        np.testing.assert_array_equal(want, tt[key].numpy(), err_msg=key)
    assert float(tt["adc_steps"][0]) == 2 ** tcfg.code_bits - 1
    # the readout matmul sums in another order than XLA: logits to a
    # tolerance; the spike counts behind them exactly (identity readout)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-5, atol=1e-6)
    eye = dict(tp, w_out=torch.eye(tcfg.n_hidden))
    tc, _ = t_snn.forward_silicon(eye, ev, tcfg, seed=seed,
                                  noise=T_NOISE if noisy else None,
                                  device="cpu")
    np.testing.assert_array_equal(tc.numpy() * t, jcounts)
    assert jcounts.sum() > 0


def test_nld_init_params_shapes():
    _, tcfg, _, _ = _setup()
    p = t_snn.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert set(p) == {"dend", "w_out"}
    assert p["dend"].w_syn.shape == (2, tcfg.n_in, tcfg.n_hidden)
    assert p["w_out"].shape == (tcfg.n_hidden, tcfg.n_classes)


def _traffic(n, n_in, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        t = int(rs.randint(5, 15))
        rate = (0.05, 0.2, 0.4)[i % 3]
        out.append(rs.choice([-1.0, 0.0, 1.0],
                             p=[rate / 2, 1 - rate, rate / 2],
                             size=(t, n_in)).astype(np.float32))
    return out


def _assert_one_shot(tp, tcfg, reqs, noise):
    for r in reqs:
        assert r.state == lifecycle.COMPLETED
        logits, tele = t_snn.forward_silicon(
            tp, r.events[None], tcfg, seed=r.seed if noise else 0,
            noise=noise, device="cpu")
        assert torch.equal(logits[0], r.logits), r.uid
        assert float(tele["adc_steps"][0]) == r.adc_steps
        assert float(tele["sops"][0]) == r.sops


@pytest.mark.parametrize("noise", [None, T_NOISE], ids=["clean", "noisy"])
def test_nld_continuous_equals_one_shot_with_preemption(noise):
    """Continuous NLD serving: every request equals its one-shot batch-1
    run, including one preempted at step 5 (round_steps 4) that resumes in
    another slot."""
    _, tcfg, _, tp = _setup()
    eng = SNNEventEngine(tcfg, tp, batch_slots=2, round_steps=4, seed=5,
                         noise=noise, backoff_rounds=3,
                         pack_by_density=False, device="cpu")
    assert eng.continuous
    rs = np.random.RandomState(2)
    traffic = [rs.choice([-1.0, 0.0, 1.0], p=[0.1, 0.8, 0.1],
                         size=(t, tcfg.n_in)).astype(np.float32)
               for t in (13, 5, 14, 6)]
    reqs = [eng.submit(EventRequest(uid=i, events=ev))
            for i, ev in enumerate(traffic)]
    seen = {}

    def hook(e):
        if "slot" not in seen:
            seen["slot"] = next(i for i, r in enumerate(e._slot_req)
                                if r is not None and r.uid == 0)
            e.preempt_request(0, at_step=5)
            assert reqs[0]._ckpt.steps_done == 5
        elif "resumed" not in seen:
            for i, r in enumerate(e._slot_req):
                if r is not None and r.uid == 0:
                    seen["resumed"] = i

    eng.run(round_hook=hook)
    assert reqs[0].preemptions == 1
    assert seen["resumed"] != seen["slot"]
    _assert_one_shot(tp, tcfg, reqs, noise)
    assert eng.energy_report("dvs_gesture") == {}     # no early stop in NLD
    assert eng.metrics.value("terminal_total", state="completed") == 4


def test_nld_serving_many_requests_and_jax_reference():
    """Mixed lengths and densities over 3 slots; clean served requests also
    match the JAX harness (logits to the readout tolerance, ADC steps and
    SOPs exactly)."""
    jcfg, tcfg, p, tp = _setup(seed=3)
    eng = SNNEventEngine(tcfg, tp, batch_slots=3, round_steps=4, seed=1,
                         device="cpu")
    reqs = [eng.submit(EventRequest(uid=i, events=ev))
            for i, ev in enumerate(_traffic(7, tcfg.n_in, seed=4))]
    out = eng.run()
    assert [r.uid for r in out] == list(range(7))
    _assert_one_shot(tp, tcfg, reqs, None)
    for r in reqs[:3]:
        jl, _, jt = _jax_harness(p, r.events[None], jcfg, 0, None)
        np.testing.assert_allclose(r.logits.numpy(), jl[0], rtol=1e-5,
                                   atol=1e-6)
        assert r.adc_steps == float(jt["adc_steps"][0])
        assert r.sops == float(jt["sops"][0])


def test_nld_stream_draws_no_prbs_bits():
    """The NLD head has no SNL: a round leaves every slot's LFSR as it
    was."""
    _, tcfg, _, tp = _setup()
    state = t_snn.silicon_stream_init(tcfg, 2, device="cpu")
    state = t_snn.silicon_stream_admit(state, np.array([True, True]),
                                       np.array([6, 6]), np.array([0, 0]))
    ev = torch.from_numpy(_events(2, 4, tcfg.n_in).transpose(1, 0, 2)
                          .copy())
    new = t_snn.forward_silicon_stream(tp, ev, tcfg, state)
    assert torch.equal(new.prbs, state.prbs)
    assert new.steps_done.tolist() == [4, 4]
