"""The port's single-layer KWN model against the JAX package on the CPU.

Clean: ``repro_torch`` ``forward_silicon(fused="seq")`` against JAX
``forward_silicon(fused=False)`` (the composed path, which the JAX suite
pins bit for bit to the fused one): spike counts, ADC steps, LIF updates
and SOPs exact, logits to a tolerance (the readout matmul sums in another
order).  Noisy: against a JAX harness built from
``kernels.ref.fused_macro_seq_ref`` with the same seed, the same left fold
and the same readout (the JAX fused launch cannot run on jax 0.9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lif as j_lif
from repro.core import macro as j_macro
from repro.core import ternary as j_ternary
from repro.core import ima as j_ima
from repro.kernels import fused_macro as j_fused
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.models import snn as j_snn
from repro_torch import convert
from repro_torch.core import ima as t_ima
from repro_torch.models import snn as t_snn

torch.set_num_threads(1)

KW = dict(n_in=96, n_hidden=40, n_classes=5, n_steps=12, k=6)


def _setup(seed=0, n_classes=None, **kw):
    cfg_kw = dict(KW, **kw)
    if n_classes is not None:
        cfg_kw["n_classes"] = n_classes
    jcfg = j_snn.SNNConfig(**cfg_kw)
    tcfg = t_snn.SNNConfig(**cfg_kw)
    p = {k: np.asarray(v) for k, v in
         j_snn.init_params(jcfg, jax.random.PRNGKey(seed)).items()}
    return jcfg, tcfg, p


def _events(b, t, n_in, seed=0, rate=0.12):
    rs = np.random.RandomState(seed)
    return rs.choice([-1.0, 0.0, 1.0], p=[rate / 2, 1 - rate, rate / 2],
                     size=(b, t, n_in)).astype(np.float32)


def test_convert_round_trip():
    jcfg, tcfg, p = _setup()
    tp = convert.snn_params_from_jax(p, device="cpu")
    for name in ("w_hid", "w_out"):
        np.testing.assert_array_equal(tp[name].numpy(), p[name])
    mcfg = j_macro.CIMMacroConfig(code_bits=5, mac_range=24.0)
    fw = j_snn._pack_fused({k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                           "kwn", mcfg)
    tfw = convert.fused_weights_from_jax(fw, device="cpu")
    own = t_snn.pack_fused(tp, tcfg)
    for name in ("msb", "lsb", "scale", "boundaries", "levels"):
        np.testing.assert_array_equal(getattr(tfw, name).numpy(),
                                      np.asarray(getattr(fw, name)))
        assert torch.equal(getattr(tfw, name), getattr(own, name)), name


@pytest.mark.parametrize("b,t", [(1, 12), (4, 9), (3, 16)])
def test_clean_forward_matches_composed_reference(b, t):
    jcfg, tcfg, p = _setup()
    ev = _events(b, t, jcfg.n_in, seed=t)
    jl, jt = j_snn.forward_silicon({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(ev), jcfg,
                                   jax.random.PRNGKey(1), fused=False)
    tl, tt = t_snn.forward_silicon(convert.snn_params_from_jax(p, "cpu"), ev,
                                   tcfg, device="cpu")
    for key in ("adc_steps", "lif_updates", "sops"):
        np.testing.assert_array_equal(np.asarray(jt[key]), tt[key].numpy(),
                                      err_msg=key)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.argmax(np.asarray(jl), -1))


def test_clean_spike_counts_exact():
    """An identity readout makes the logits the spike rates, exactly."""
    jcfg, tcfg, p = _setup(n_classes=KW["n_hidden"])
    p["w_out"] = np.eye(KW["n_hidden"], dtype=np.float32)
    ev = _events(5, 14, jcfg.n_in, seed=3, rate=0.2)
    jl, _ = j_snn.forward_silicon({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(ev), jcfg,
                                  jax.random.PRNGKey(2), fused=False)
    tl, _ = t_snn.forward_silicon(convert.snn_params_from_jax(p, "cpu"), ev,
                                  tcfg, device="cpu")
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tl.sum() > 0


def _jax_noisy_harness(p, ev, cfg, seed, noise):
    """What JAX ``forward_silicon(fused="seq", noise=...)`` computes,
    through the oracle instead of the Pallas launch."""
    mcfg = j_macro.CIMMacroConfig(code_bits=cfg.code_bits,
                                  mac_range=cfg.mac_range, ima_noise=noise)
    fw = j_snn._pack_fused(p, cfg, "kwn", mcfg)
    kn = j_macro.fused_kernel_noise(fw, mcfg)
    b, t = ev.shape[0], ev.shape[1]
    ev_t = j_ternary.ternary_input_encode(jnp.moveaxis(jnp.asarray(ev), 1, 0))
    _, _, spk, _, steps = j_ref.fused_macro_seq_ref(
        ev_t, fw.msb, fw.lsb, fw.boundaries, fw.levels, fw.scale,
        jnp.zeros((b, cfg.n_hidden)), None, k=cfg.k,
        drive_gain=cfg.drive_gain, beta=cfg.beta, v_th1=cfg.v_th1,
        v_th2=cfg.v_th2, v_reset=0.0, v_lim=j_lif.vmem_limit(12),
        use_snl=True, ima_noise=kn, snl_amp=cfg.noise_amp, seed=seed)
    counts = jnp.sum(spk, 0)
    logits = (counts / t) @ p["w_out"]
    adc = jnp.sum(steps[..., 0].astype(jnp.float32), 0) / t
    return np.asarray(logits), np.asarray(adc), np.asarray(counts)


@pytest.mark.parametrize("seed", [0, 123456789])
def test_noisy_forward_matches_oracle_harness(seed):
    jcfg, tcfg, p = _setup(seed=1)
    ev = _events(3, 10, jcfg.n_in, seed=7, rate=0.25)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jl, jadc, _ = _jax_noisy_harness(jp, ev, jcfg, seed, j_ima.IMANoiseModel())
    tl, tt = t_snn.forward_silicon(convert.snn_params_from_jax(p, "cpu"), ev,
                                   tcfg, seed=seed,
                                   noise=t_ima.IMANoiseModel(), device="cpu")
    np.testing.assert_array_equal(tt["adc_steps"].numpy(), jadc)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), np.argmax(jl, -1))


def test_skipped_block_ratio_matches_reference_map():
    jcfg, tcfg, p = _setup()
    ev = _events(3, 8, jcfg.n_in, seed=9, rate=0.01)
    ev[:, ::2] = 0.0
    _, tt = t_snn.forward_silicon(convert.snn_params_from_jax(p, "cpu"), ev,
                                  tcfg, device="cpu")
    ev_t = np.moveaxis(ev, 1, 0)
    plan = j_fused.plan_tiles(3, jcfg.n_in, jcfg.n_hidden, jcfg.n_hidden, 8,
                              use_cache=False)
    xm = jnp.pad(jnp.asarray(ev_t), ((0, 0), (0, plan.m_pad - 3),
                                     (0, plan.k_pad - jcfg.n_in)))
    act = j_ops.fused_activity_map(xm, plan)
    want = jnp.clip(1.0 - jnp.mean(act.astype(jnp.float32)), 0.0, 1.0)
    np.testing.assert_array_equal(tt["skipped_block_ratio"].numpy(),
                                  np.full(3, np.asarray(want)))
    assert 0.0 < float(want) < 1.0


@pytest.mark.parametrize("fused", [False])
def test_unported_paths_raise(fused):
    _, tcfg, p = _setup()
    tp = convert.snn_params_from_jax(p, "cpu")
    with pytest.raises(NotImplementedError, match="composed stage chain"):
        t_snn.forward_silicon(tp, _events(1, 4, tcfg.n_in), tcfg,
                              device="cpu", fused=fused)
    # layer stacks are ported on the fused paths only, like single layers
    scfg = t_snn.SNNConfig(n_in=16, hidden_layers=(8, 8))
    sp = t_snn.init_params(scfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="composed stage chain"):
        t_snn.forward_silicon(sp, _events(1, 4, 16), scfg, device="cpu",
                              fused=fused)


def test_init_params_is_seeded():
    _, tcfg, _ = _setup()
    a = t_snn.init_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    b = t_snn.init_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    assert a["w_hid"].shape == (tcfg.n_in, tcfg.n_hidden)
    assert a["w_out"].shape == (tcfg.n_hidden, tcfg.n_classes)
    assert all(torch.equal(a[k], b[k]) for k in a)

