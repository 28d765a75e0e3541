"""The port's training slice against the JAX package on the CPU.

Silicon-in-the-loop training: the port's ``ops.fused_macro_seq_vjp`` (the
seq-KWN forward with its membrane trace, and the plain version of the
surrogate backward, ``ref.fused_macro_seq_grad_ref``) held to the JAX
differentiable oracle ``repro.kernels.ref.fused_macro_seq_vjp_ref``: the
forward bit for bit, the gradients of ``(w, v)`` under a fixed linear loss
within ``rtol=1e-5, atol=1e-6`` (the reference's own tolerance for its
backward kernel: the two sum ``dW`` in other orders).  The JAX package's
Pallas launches do not run on jax 0.9, so the model-level silicon loss is
held to a JAX harness built on that oracle.

Software BPTT (``forward_train``) is held to the JAX package's own
``forward_train`` and ``jax.grad``: spike counts exact, logits, losses and
gradients within ``rtol=1e-5, atol=1e-6`` (the MAC and readout matrix
products sum in other orders).

Operands come from ``numpy.random.RandomState`` and go to both sides.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ima as j_ima
from repro.core import lif as j_lif
from repro.core import macro as j_macro
from repro.core import prbs as j_prbs
from repro.core import ternary as j_ternary
from repro.data import events as j_events
from repro.kernels import ref as j_ref
from repro.models import snn as j_snn
from repro.train import silicon as j_sil
from repro_torch import convert
from repro_torch.core import ima as t_ima
from repro_torch.core import lif as t_lif
from repro_torch.core import macro as t_macro
from repro_torch.core import prbs as t_prbs
from repro_torch.core import ternary as t_ternary
from repro_torch.data import events as t_events
from repro_torch.kernels import ops, ref
from repro_torch.models import snn as t_snn
from repro_torch.train import silicon as t_sil

torch.set_num_threads(1)

KW = dict(k=12, drive_gain=0.25, use_snl=True, snl_amp=0.05)
STE = dict(ste_lo=-24.5, ste_hi=24.5)
TOL = dict(rtol=1e-5, atol=1e-6)
# (T, M, K, N): one K tile and one column tile; two row tiles and a K tile
# of 128; M, K and N all padded
SHAPES = {"single": (5, 8, 256, 128), "rows": (4, 136, 96, 40),
          "padded": (7, 37, 300, 100)}


def _operands(shape, seed=0):
    t, m, k_dim, n = SHAPES[shape]
    rs = np.random.RandomState(seed)
    x = rs.choice([-1.0, 0.0, 1.0], p=[0.06, 0.88, 0.06],
                  size=(t, m, k_dim)).astype(np.float32)
    x[1] = 0.0                          # an empty step: gated row tiles
    w = rs.randint(-3, 4, (k_dim, n)).astype(np.float32)
    scale = rs.uniform(0.05, 0.3, n).astype(np.float32)
    v = (rs.randn(m, n) * 0.5).astype(np.float32)
    g_spk = rs.randn(t, m, n).astype(np.float32)
    g_vfin = rs.randn(m, n).astype(np.float32)
    return x, w, scale, v, g_spk, g_vfin


def _snl(kind, shape):
    """(use_snl, streamed noise or None, counter SNL amplitude, noisy);
    clean streams the PRBS-15 SNL noise of a fresh LIF state."""
    t, m, _, n = SHAPES[shape]
    if kind == "clean":
        nz = t_prbs.sequence_noise(m, t, n, 0.05, "cpu").numpy()
        return True, nz, 0.0, False
    if kind == "noisy":
        return True, None, 0.05, True
    return False, None, 0.0, False      # SNL off


def _codebooks(noisy):
    jcb, tcb = j_ima.nlq_codebook(5, -24, 24), t_ima.nlq_codebook(5, -24, 24)
    if not noisy:
        return jcb, tcb, None, None
    return (jcb, tcb, j_ima.kernel_noise_params(j_ima.IMANoiseModel(), jcb),
            t_ima.kernel_noise_params(t_ima.IMANoiseModel(), tcb))


def _oracle(w, x, scale, v, jcb, kn, nz, use_snl, snl_amp, relax, seed=7):
    return j_ref.fused_macro_seq_vjp_ref(
        w, jnp.asarray(x), jcb.boundaries, jcb.levels, jnp.asarray(scale), v,
        None if nz is None else jnp.asarray(nz), seed=seed, ima_noise=kn,
        kwn_relax=relax, **dict(KW, use_snl=use_snl, snl_amp=snl_amp),
        **STE)


@functools.lru_cache(maxsize=None)
def _oracle_grads(shape, kind, relax, seed=7):
    """jax.grad of the JAX oracle under ``sum(spikes * g_spk) +
    sum(v_fin * g_vfin)``: (dW, dv0) as numpy."""
    x, w, scale, v, g_spk, g_vfin = _operands(shape)
    use_snl, nz, amp, noisy = _snl(kind, shape)
    jcb, _, kn, _ = _codebooks(noisy)

    def loss(w_, v_):
        v_fin, spk = _oracle(w_, x, scale, v_, jcb, kn, nz, use_snl, amp,
                             relax, seed)[:2]
        return jnp.sum(spk * g_spk) + jnp.sum(v_fin * g_vfin)

    dw, dv = jax.grad(loss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(v))
    return np.asarray(dw), np.asarray(dv)


def _port_grads(shape, kind, relax, remat, gate, seed=7):
    x, w, scale, v, g_spk, g_vfin = _operands(shape)
    use_snl, nz, amp, noisy = _snl(kind, shape)
    _, tcb, _, tkn = _codebooks(noisy)
    spec = ops.SeqVJPSpec(ima_noise=tkn, kwn_relax=relax, remat=remat,
                          gate=gate, **dict(KW, use_snl=use_snl,
                                            snl_amp=amp), **STE)
    wt = torch.tensor(w, requires_grad=True)
    vt = torch.tensor(v, requires_grad=True)
    spk, v_fin = ops.fused_macro_seq_vjp(
        spec, wt, torch.tensor(x), tcb.boundaries, tcb.levels,
        torch.tensor(scale), vt, None if nz is None else torch.tensor(nz),
        seed)
    loss = (spk * torch.tensor(g_spk)).sum() \
        + (v_fin * torch.tensor(g_vfin)).sum()
    dw, dv = torch.autograd.grad(loss, (wt, vt))
    return dw.numpy(), dv.numpy()


# --- the forward with its training trace -----------------------------------

@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", ["clean", "noisy", "snl_off"])
def test_trace_forward_equals_oracle_primal(shape, kind):
    x, w, scale, v, _, _ = _operands(shape)
    use_snl, nz, amp, noisy = _snl(kind, shape)
    jcb, tcb, kn, tkn = _codebooks(noisy)
    v_fin, spk, mask, steps, vtrace = _oracle(
        jnp.asarray(w), x, scale, jnp.asarray(v), jcb, kn, nz, use_snl, amp,
        0.1)
    msb, lsb = t_ternary.weight_decompose(torch.tensor(w))
    _, tv, tspk, tmask, tsteps, tvtrace = ops.fused_macro_seq(
        torch.tensor(x), t_ternary.pack_ternary(msb),
        t_ternary.pack_ternary(lsb), tcb.boundaries, tcb.levels,
        torch.tensor(scale), torch.tensor(v),
        None if nz is None else torch.tensor(nz), seed=7, ima_noise=tkn,
        train_trace=True, device="cpu",
        **dict(KW, use_snl=use_snl, snl_amp=amp))
    for name, a, b in (("v_fin", tv, v_fin), ("spikes", tspk, spk),
                       ("mask", tmask, mask), ("vtrace", tvtrace, vtrace),
                       ("steps", tsteps, steps[..., 0])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert tspk.sum() > 0 and (tvtrace.abs() < 8.0).any()


def test_train_trace_is_kwn_only():
    x = torch.zeros((2, 4, 32))
    planes = torch.zeros((32, 16), dtype=torch.int8)
    cb = t_ima.nlq_codebook(5, -4, 4)
    with pytest.raises(ValueError, match="KWN-only"):
        ops.fused_macro_seq(x, planes, planes, cb.boundaries, cb.levels,
                            torch.ones(16), torch.zeros((4, 8)), None,
                            torch.ones((2, 8)), mode="nld",
                            train_trace=True, device="cpu")


# --- the plain backward against jax.grad of the oracle ---------------------

@pytest.mark.parametrize("shape", ["single", "padded"])
@pytest.mark.parametrize("kind", ["clean", "noisy"])
@pytest.mark.parametrize("relax", [0.0, 0.1])
@pytest.mark.parametrize("remat,gate", [(False, True), (True, True),
                                        (False, False), (True, False)],
                         ids=["residual-gated", "remat-gated",
                              "residual-dense", "remat-dense"])
def test_plain_backward_matches_oracle_grad(shape, kind, relax, remat, gate):
    dw_r, dv_r = _oracle_grads(shape, kind, relax)
    dw, dv = _port_grads(shape, kind, relax, remat, gate)
    np.testing.assert_allclose(dw, dw_r, **TOL)
    np.testing.assert_allclose(dv, dv_r, **TOL)
    assert np.abs(dw_r).max() > 0


@pytest.mark.parametrize("shape", ["rows", "padded"])
@pytest.mark.parametrize("kind", ["clean", "noisy", "snl_off"])
@pytest.mark.parametrize("relax", [0.0, 0.1])
def test_autograd_oracle_matches_jax_oracle(shape, kind, relax):
    """The port's oracle (torch autograd) is the second witness: its values
    equal the JAX oracle's bit for bit, its gradients within tolerance."""
    x, w, scale, v, g_spk, g_vfin = _operands(shape)
    use_snl, nz, amp, noisy = _snl(kind, shape)
    jcb, tcb, kn, tkn = _codebooks(noisy)
    want = _oracle(jnp.asarray(w), x, scale, jnp.asarray(v), jcb, kn, nz,
                   use_snl, amp, relax)
    wt = torch.tensor(w, requires_grad=True)
    vt = torch.tensor(v, requires_grad=True)
    got = ref.fused_macro_seq_vjp_ref(
        wt, torch.tensor(x), tcb.boundaries, tcb.levels, torch.tensor(scale),
        vt, None if nz is None else torch.tensor(nz), seed=7,
        ima_noise=tkn, kwn_relax=relax,
        **dict(KW, use_snl=use_snl, snl_amp=amp), **STE)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    loss = (got[1] * torch.tensor(g_spk)).sum() \
        + (got[0] * torch.tensor(g_vfin)).sum()
    dw, dv = torch.autograd.grad(loss, (wt, vt))
    dw_r, dv_r = _oracle_grads(shape, kind, relax)
    np.testing.assert_allclose(dw.numpy(), dw_r, **TOL)
    np.testing.assert_allclose(dv.numpy(), dv_r, **TOL)


# --- the reference's exact pins, held in the port --------------------------

@pytest.mark.parametrize("shape", ["rows", "padded"])
def test_remat_and_gating_leave_gradients_bitwise(shape):
    base = _port_grads(shape, "noisy", 0.1, False, True)
    for remat, gate in ((True, True), (False, False), (True, False)):
        dw, dv = _port_grads(shape, "noisy", 0.1, remat, gate)
        np.testing.assert_array_equal(dw, base[0])
        np.testing.assert_array_equal(dv, base[1])


def test_noisy_gradients_are_a_function_of_the_seed():
    a = _port_grads("single", "noisy", 0.1, False, True, seed=11)
    b = _port_grads("single", "noisy", 0.1, False, True, seed=11)
    c = _port_grads("single", "noisy", 0.1, False, True, seed=12)
    np.testing.assert_array_equal(a[0], b[0])
    assert not np.array_equal(a[0], c[0])


# --- the straight-through helpers ------------------------------------------

def _w(seed=0, shape=(64, 24)):
    rs = np.random.RandomState(seed)
    w = (rs.randn(*shape) * 0.4).astype(np.float32)
    w[3, :] = 0.0
    return w


def test_quantized_weight_ste_matches_reference():
    w = _w()
    g = np.random.RandomState(1).randn(*w.shape).astype(np.float32)
    jw, jscale = j_sil.quantized_weight_ste(jnp.asarray(w))
    jgrad = jax.grad(lambda a: jnp.sum(j_sil.quantized_weight_ste(a)[0]
                                       * g))(jnp.asarray(w))
    wt = torch.tensor(w, requires_grad=True)
    tw, tscale = t_sil.quantized_weight_ste(wt)
    np.testing.assert_array_equal(tw.detach().numpy(), np.asarray(jw))
    np.testing.assert_array_equal(
        tw.detach().numpy(),
        np.asarray(j_ternary.quantize_weights_3bit(jnp.asarray(w))[0]))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    (tgrad,) = torch.autograd.grad((tw * torch.tensor(g)).sum(), wt)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), **TOL)


def test_quantize_weights_ste_matches_reference():
    w = _w(2)
    g = np.random.RandomState(3).randn(*w.shape).astype(np.float32)
    jq = j_ternary.quantize_weights_ste(jnp.asarray(w))
    jgrad = jax.grad(lambda a: jnp.sum(j_ternary.quantize_weights_ste(a)
                                       * g))(jnp.asarray(w))
    wt = torch.tensor(w, requires_grad=True)
    tq = t_ternary.quantize_weights_ste(wt)
    np.testing.assert_array_equal(tq.detach().numpy(), np.asarray(jq))
    (tgrad,) = torch.autograd.grad((tq * torch.tensor(g)).sum(), wt)
    np.testing.assert_array_equal(tgrad.numpy(), np.asarray(jgrad))


def test_ima_quantize_ste_matches_reference():
    x = np.linspace(-30.0, 30.0, 2401, dtype=np.float32)
    jcb, tcb = j_ima.nlq_codebook(5, -24, 24), t_ima.nlq_codebook(5, -24, 24)
    jq = j_ima.ima_quantize_ste(jnp.asarray(x), jcb)
    jgrad = jax.grad(lambda a: jnp.sum(j_ima.ima_quantize_ste(a, jcb)
                                       * 2.0))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    tq = t_ima.ima_quantize_ste(xt, tcb)
    np.testing.assert_array_equal(tq.detach().numpy(), np.asarray(jq))
    (tgrad,) = torch.autograd.grad((tq * 2.0).sum(), xt)
    np.testing.assert_array_equal(tgrad.numpy(), np.asarray(jgrad))
    assert 0 < tgrad.count_nonzero() < x.size


def test_spike_fn_matches_reference():
    v = np.linspace(-2.0, 3.0, 1001, dtype=np.float32)
    js = j_lif.spike_fn(jnp.asarray(v), jnp.asarray(1.0))
    jgrad = jax.grad(lambda a: jnp.sum(j_lif.spike_fn(a, jnp.asarray(1.0))
                                       * 1.5))(jnp.asarray(v))
    vt = torch.tensor(v, requires_grad=True)
    ts = t_lif.spike_fn(vt, 1.0)
    np.testing.assert_array_equal(ts.detach().numpy(), np.asarray(js))
    (tgrad,) = torch.autograd.grad((ts * 1.5).sum(), vt)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), **TOL)


# --- the model: silicon loss and gradients ---------------------------------

SIL = dict(n_in=96, n_hidden=40, n_classes=5, n_steps=12, k=6)


def _events(b, t, n_in, seed=0, rate=0.2):
    rs = np.random.RandomState(seed)
    return rs.choice([-1.0, 0.0, 1.0], p=[rate / 2, 1 - rate, rate / 2],
                     size=(b, t, n_in)).astype(np.float32)


def _model(seed=1, **kw):
    cfg_kw = dict(SIL, **kw)
    jcfg, tcfg = j_snn.SNNConfig(**cfg_kw), t_snn.SNNConfig(**cfg_kw)
    p = jax.tree.map(np.asarray,
                     j_snn.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, tcfg, p


def _jax_silicon_harness(p, ev, cfg, seed, noise, kwn_relax=0.1):
    """What JAX ``train.silicon.forward_logits`` computes, with the oracle
    in place of the fused VJP: (logits, spikes (T, B, N))."""
    b, t = ev.shape[0], ev.shape[1]
    w, scale = j_sil.quantized_weight_ste(p["w_hid"])
    nlq = j_ima.nlq_codebook(cfg.code_bits, -cfg.mac_range, cfg.mac_range)
    kn = None if noise is None else j_ima.kernel_noise_params(noise, nlq)
    noise_t = None
    if noise is None and cfg.use_snl:
        st0 = j_lif.lif_init((b, cfg.n_hidden))

        def draw(s, _):
            return j_prbs.prbs_noise(s, (b, cfg.n_hidden), cfg.noise_amp)

        _, noise_t = jax.lax.scan(draw, st0.prbs_state, None, length=t)
    v_fin, spk, *_ = j_ref.fused_macro_seq_vjp_ref(
        w, jnp.moveaxis(ev, 1, 0), nlq.boundaries, nlq.levels, scale,
        jnp.zeros((b, cfg.n_hidden)), noise_t, k=cfg.k,
        drive_gain=cfg.drive_gain, beta=cfg.beta, v_th1=cfg.v_th1,
        v_th2=cfg.v_th2, v_reset=0.0, v_lim=j_lif.vmem_limit(12),
        use_snl=cfg.use_snl, ima_noise=kn,
        snl_amp=cfg.noise_amp if noise is not None else 0.0, seed=seed,
        kwn_relax=kwn_relax, ste_lo=-cfg.mac_range - 0.5,
        ste_hi=cfg.mac_range + 0.5)
    return (jnp.sum(spk, 0) / t) @ p["w_out"], spk


def _jax_silicon_loss(p, ev, lab, cfg, seed, noise):
    logits, _ = _jax_silicon_harness(p, ev, cfg, seed, noise)
    lse = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(lse, lab[:, None], 1))


def _silicon_case(noisy, seed=5):
    jcfg, tcfg, p = _model()
    ev = _events(4, 11, SIL["n_in"], seed=seed)
    lab = np.random.RandomState(seed).randint(0, SIL["n_classes"], 4)
    noise = (j_ima.IMANoiseModel(), t_ima.IMANoiseModel()) if noisy \
        else (None, None)
    return jcfg, tcfg, p, ev, lab, noise


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
def test_silicon_loss_and_grads_match_jax_harness(noisy):
    jcfg, tcfg, p, ev, lab, (jn, tn) = _silicon_case(noisy)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jloss, jg = jax.value_and_grad(_jax_silicon_loss)(
        jp, jnp.asarray(ev), jnp.asarray(lab), jcfg, 9, jn)
    tp = {k: v.requires_grad_(True) for k, v in
          convert.snn_params_from_jax(p, "cpu").items()}
    tloss = t_snn.loss_fn(tp, torch.tensor(ev), torch.tensor(lab), tcfg, 9,
                          silicon=True, noise=tn)
    tg = torch.autograd.grad(tloss, [tp["w_hid"], tp["w_out"]])
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    for name, g in zip(("w_hid", "w_out"), tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[name]),
                                   err_msg=name, **TOL)
        assert float(g.abs().max()) > 0.0, name
    # the spikes under the loss, through the same pieces forward_logits uses
    _, jspk = _jax_silicon_harness(jp, jnp.asarray(ev), jcfg, 9, jn)
    w, scale = t_sil.quantized_weight_ste(tp["w_hid"])
    mcfg = t_macro.CIMMacroConfig(mac_range=tcfg.mac_range, ima_noise=tn)
    nz = None if noisy else torch.tensor(np.asarray(jax.lax.scan(
        lambda s, _: j_prbs.prbs_noise(s, (4, 40), 0.05),
        j_lif.lif_init((4, 40)).prbs_state, None, length=11)[1]))
    tspk, _ = t_macro.fused_seq_vjp(
        torch.tensor(ev).transpose(0, 1), w, scale, mcfg,
        torch.zeros((4, 40)), k=tcfg.k, drive_gain=tcfg.drive_gain,
        v_lim=t_lif.vmem_limit(12), noise=nz,
        snl_amp=0.05 if noisy else 0.0, kwn_relax=0.1, seed=9)
    np.testing.assert_array_equal(tspk.detach().numpy(), np.asarray(jspk))
    assert tspk.sum() > 0


def test_silicon_forward_equals_serving_forward():
    """The training forward is the serving forward: same logits."""
    _, tcfg, p, ev, _, _ = _silicon_case(False)
    tp = convert.snn_params_from_jax(p, "cpu")
    served, _ = t_snn.forward_silicon(tp, ev, tcfg, device="cpu")
    trained = t_sil.forward_logits(tp, torch.tensor(ev), tcfg, 0)
    assert torch.equal(served, trained)


def test_silicon_training_rejects_nld_and_stacks():
    ev = torch.tensor(_events(2, 4, SIL["n_in"]))
    lab = torch.zeros(2, dtype=torch.int64)
    _, ncfg, np_ = _model(mode="nld")
    with pytest.raises(ValueError, match="kwn"):
        t_snn.loss_fn(convert.snn_params_from_jax(np_, "cpu"), ev, lab, ncfg,
                      0, silicon=True)
    scfg = t_snn.SNNConfig(n_in=SIL["n_in"], hidden_layers=(16, 8))
    sp = t_snn.init_params(scfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="single-layer"):
        t_snn.loss_fn(sp, ev, lab, scfg, 0, silicon=True)


# --- the model: software BPTT ----------------------------------------------

SOFTWARE = {
    "kwn": dict(),
    "nld_relu": dict(mode="nld", n_branches=2, activation="relu"),
    "nld_sigmoid4": dict(mode="nld", n_branches=3, activation="sigmoid4"),
    "stack": dict(hidden_layers=(48, 40), k_layers=(6, 5)),
}


def _jax_grad_leaves(g):
    out = {"w_out": g["w_out"]}
    if "dend" in g:
        out.update({f"dend.{k}": getattr(g["dend"], k)
                    for k in ("w_syn", "w_dend", "mask")})
    elif isinstance(g["w_hid"], (list, tuple)):
        out.update({f"w_hid.{i}": a for i, a in enumerate(g["w_hid"])})
    else:
        out["w_hid"] = g["w_hid"]
    return {k: np.asarray(v) for k, v in out.items()}


def _port_grad_leaves(tp, grads):
    names = []
    for name, w in tp.items():
        if name == "dend":
            names += [f"dend.{k}" for k in ("w_syn", "w_dend", "mask")]
        elif isinstance(w, (list, tuple)):
            names += [f"w_hid.{i}" for i in range(len(w))]
        else:
            names.append(name)
    return dict(zip(names, (g.numpy() for g in grads)))


@pytest.mark.parametrize("case", list(SOFTWARE))
def test_software_forward_and_grads_match_reference(case):
    jcfg, tcfg, p = _model(seed=2, **SOFTWARE[case])
    ev = _events(6, 10, SIL["n_in"], seed=4, rate=0.3)
    lab = np.random.RandomState(4).randint(0, SIL["n_classes"], 6)
    jp = jax.tree.map(jnp.asarray, p)
    jl = j_snn.forward_train(jp, jnp.asarray(ev), jcfg)
    jloss, jg = jax.value_and_grad(j_snn.loss_fn)(
        jp, jnp.asarray(ev), jnp.asarray(lab), jcfg)
    tp = t_snn._tree_map(lambda a: a.requires_grad_(True),
                         convert.snn_params_from_jax(p, "cpu"))
    tl = t_snn.forward_train(tp, torch.tensor(ev), tcfg)
    tloss = t_snn.loss_fn(tp, torch.tensor(ev), torch.tensor(lab), tcfg)
    tg = torch.autograd.grad(tloss, t_snn._tree_leaves(tp))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    want = _jax_grad_leaves(jg)
    got = _port_grad_leaves(tp, tg)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **TOL)
    assert max(np.abs(g).max() for g in want.values()) > 0


@pytest.mark.parametrize("case", list(SOFTWARE))
def test_software_spike_counts_exact(case):
    """An identity readout makes the logits the spike rates, exactly."""
    jcfg, tcfg, p = _model(seed=2, n_classes=40, **SOFTWARE[case])
    p["w_out"] = np.eye(40, dtype=np.float32)
    ev = _events(6, 10, SIL["n_in"], seed=4, rate=0.3)
    jl = j_snn.forward_train(jax.tree.map(jnp.asarray, p), jnp.asarray(ev),
                             jcfg)
    tl = t_snn.forward_train(convert.snn_params_from_jax(p, "cpu"),
                             torch.tensor(ev), tcfg)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tl.sum() > 0


# --- one optimizer step ----------------------------------------------------

@pytest.mark.parametrize("silicon", [False, True], ids=["software",
                                                        "silicon"])
def test_train_step_matches_reference_step(silicon):
    """One SGD-momentum step from the same params, momentum, batch and
    seed.  The reference step is its loss and update rule run eagerly:
    ``jax.jit`` of the same gradient differs from the eager one by up to
    6e-5 at this seed (the values agree), so the jitted ``train_step`` is
    no tighter witness than the eager one."""
    jcfg, tcfg, p, ev, lab, (jn, tn) = _silicon_case(True, seed=6)
    rs = np.random.RandomState(8)
    m = {k: (rs.randn(*v.shape) * 0.01).astype(np.float32)
         for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jm = {k: jnp.asarray(v) for k, v in m.items()}
    lr = 0.05
    if silicon:
        g = jax.grad(_jax_silicon_loss)(jp, jnp.asarray(ev),
                                        jnp.asarray(lab), jcfg, 9, jn)
    else:
        g = jax.grad(j_snn.loss_fn)(jp, jnp.asarray(ev), jnp.asarray(lab),
                                    jcfg)
    jm = jax.tree.map(lambda a, b: 0.9 * a + b, jm, g)
    jp = jax.tree.map(lambda a, b: a - lr * b, jp, jm)
    tp, tm, tloss = t_snn.train_step(
        convert.snn_params_from_jax(p, "cpu"),
        convert.snn_params_from_jax(m, "cpu"), torch.tensor(ev),
        torch.tensor(lab), tcfg, lr, 9 if silicon else None,
        silicon=silicon, noise=tn if silicon else None)
    assert tloss.dim() == 0 and torch.isfinite(tloss)
    for name in ("w_hid", "w_out"):
        np.testing.assert_allclose(tm[name].numpy(), np.asarray(jm[name]),
                                   err_msg=name, **TOL)
        np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]),
                                   err_msg=name, **TOL)
        assert not np.array_equal(tp[name].numpy(), p[name])


def test_convert_carries_a_momentum_tree():
    for kw in ({}, SOFTWARE["nld_relu"], SOFTWARE["stack"]):
        jcfg = j_snn.SNNConfig(**dict(SIL, **kw))
        p = j_snn.init_params(jcfg, jax.random.PRNGKey(0))
        m = jax.tree.map(lambda a: np.asarray(a) * 0.5 + 0.25, p)
        tm = convert.snn_params_from_jax(m, "cpu")
        want = jax.tree.leaves(m)
        got = t_snn._tree_leaves(tm)
        assert len(got) == len(want)
        for a in got:
            assert a.dtype == torch.float32
        tp = convert.snn_params_from_jax(jax.tree.map(np.asarray, p), "cpu")
        assert [tuple(a.shape) for a in t_snn._tree_leaves(tp)] \
            == [tuple(a.shape) for a in got]
        assert sorted(float(a.sum()) for a in got) == pytest.approx(
            sorted(float(np.sum(a)) for a in want), rel=1e-6)


# --- training runs ---------------------------------------------------------

def _small_dataset():
    dcfg = t_events.EventDataConfig("nmnist", 128, 10, 4, 0.06, alpha=0.6)
    return t_events.EventDataset(dcfg, device="cpu")


def test_silicon_training_loss_falls():
    ds = _small_dataset()
    cfg = t_snn.SNNConfig(n_in=128, n_hidden=64, n_classes=4, n_steps=10,
                          k=8)
    _, losses = t_snn.train(cfg, ds, n_steps=12, batch=32, lr=0.3,
                            silicon=True, noise=t_ima.IMANoiseModel(),
                            device="cpu")
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert all(isinstance(x, float) for x in losses)
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


def test_software_then_silicon_recipe_keeps_batches():
    """Warm start: the silicon run copies the params, and draws the same
    batches as a software run of the same seed (step seeds have their
    own generator)."""
    ds = _small_dataset()
    cfg = t_snn.SNNConfig(n_in=128, n_hidden=64, n_classes=4, n_steps=10,
                          k=8)
    p0, sw = t_snn.train(cfg, ds, n_steps=3, batch=16, device="cpu")
    keep = {k: v.clone() for k, v in p0.items()}
    p1, si = t_snn.train(cfg, ds, n_steps=3, batch=16, lr=0.02, seed=0,
                         silicon=True, params=p0, device="cpu")
    assert all(torch.equal(keep[k], p0[k]) for k in keep)
    assert not torch.equal(p1["w_hid"], p0["w_hid"])
    a, _ = t_snn.train_generators(0, "cpu")
    b, _ = t_snn.train_generators(0, "cpu")
    assert torch.equal(ds.sample(a, 4)[0], ds.sample(b, 4)[0])
    assert len(sw) == len(si) == 3 and np.isfinite(si).all()


def test_evaluate_reports_accuracy_and_telemetry():
    ds = _small_dataset()
    cfg = t_snn.SNNConfig(n_in=128, n_hidden=64, n_classes=4, n_steps=10,
                          k=8)
    p = t_snn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    acc, tele = t_snn.evaluate(p, cfg, ds, torch.Generator().manual_seed(1),
                               n_batches=2, batch=8, device="cpu",
                               noise=t_ima.IMANoiseModel())
    assert 0.0 <= acc <= 1.0
    assert set(tele) == {"adc_steps", "lif_updates", "sops",
                         "skipped_block_ratio"}


# --- the per-step fused path -----------------------------------------------

STEP_CFGS = {"kwn": dict(), "kwn_snl_off": dict(use_snl=False),
             "nld": dict(mode="nld", activation="relu")}


@pytest.mark.parametrize("case", list(STEP_CFGS))
@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
def test_step_path_equals_seq_path(case, noisy):
    _, tcfg, p = _model(**STEP_CFGS[case])
    tp = convert.snn_params_from_jax(p, "cpu")
    ev = _events(3, 9, SIL["n_in"], seed=2)
    ev[:, ::3, :32] = 0.0
    noise = t_ima.IMANoiseModel() if noisy else None
    ls, ts = t_snn.forward_silicon(tp, ev, tcfg, seed=77, noise=noise,
                                   fused="step", device="cpu")
    lq, tq = t_snn.forward_silicon(tp, ev, tcfg, seed=77, noise=noise,
                                   fused="seq", device="cpu")
    assert torch.equal(ls, lq)
    assert set(ts) == set(tq)
    for key in tq:
        assert torch.equal(ts[key], tq[key]), key


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
def test_stack_routes_step_to_the_stacked_kernel(noisy):
    from repro_torch.kernels import fused_macro
    _, tcfg, p = _model(**SOFTWARE["stack"])
    tp = convert.snn_params_from_jax(p, "cpu")
    ev = _events(3, 6, SIL["n_in"], seed=5)
    noise = t_ima.IMANoiseModel() if noisy else None
    before = fused_macro.fused_macro_multi_seq.launches
    ls, ts = t_snn.forward_silicon(tp, ev, tcfg, seed=4, noise=noise,
                                   fused="step", device="cpu")
    lq, tq = t_snn.forward_silicon(tp, ev, tcfg, seed=4, noise=noise,
                                   device="cpu")
    assert fused_macro.fused_macro_multi_seq.launches == before
    assert torch.equal(ls, lq)
    for key in tq:
        assert torch.equal(ts[key], tq[key]), key


def test_training_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_events.EventDataset(t_events.NMNIST)
    ds = _small_dataset()
    cfg = t_snn.SNNConfig(n_in=128, n_hidden=64, n_classes=4, n_steps=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_snn.train(cfg, ds, n_steps=1, batch=2)


def _jax_step_harness(p, ev, cfg, seed, noise):
    """What JAX ``forward_silicon(fused="step")`` computes, one oracle step
    ``fused_macro_step_ref`` per time step (the Pallas launch does not run
    on jax 0.9): the PRBS state threaded when clean KWN, the step index as
    the counter step word.  Returns (logits, adc steps per request)."""
    mcfg = j_macro.CIMMacroConfig(
        code_bits=cfg.code_bits, ima_noise=noise,
        mac_range=cfg.mac_range if cfg.mode == "kwn" else cfg.dend_range)
    fw = j_snn._pack_fused(p, cfg, cfg.mode, mcfg)
    kn = j_macro.fused_kernel_noise(fw, mcfg)
    b, t = ev.shape[0], ev.shape[1]
    kwn = cfg.mode == "kwn"
    snl = kwn and cfg.use_snl
    st = j_lif.lif_init((b, cfg.n_hidden))
    v, prbs = st.v_mem, st.prbs_state
    counts = jnp.zeros((b, cfg.n_hidden))
    adc = jnp.zeros((b,))
    for i in range(t):
        nz = jnp.zeros((b, cfg.n_hidden))
        if snl and noise is None:
            prbs, nz = j_prbs.prbs_noise(prbs, (b, cfg.n_hidden),
                                         cfg.noise_amp)
        elif noise is not None:
            nz = None
        _, v, spk, _, steps = j_ref.fused_macro_step_ref(
            j_ternary.ternary_input_encode(jnp.asarray(ev[:, i])), fw.msb,
            fw.lsb, fw.boundaries, fw.levels, fw.scale, v,
            nz, fw.w_dend, mode=cfg.mode, k=cfg.k, drive_gain=cfg.drive_gain,
            beta=cfg.beta, v_th1=cfg.v_th1, v_th2=cfg.v_th2, v_reset=0.0,
            v_lim=j_lif.vmem_limit(12), use_snl=snl, ima_noise=kn,
            snl_amp=cfg.noise_amp if snl and noise is not None else 0.0,
            seed=seed, step=i)
        counts = counts + spk
        adc = adc + steps[:, 0].astype(jnp.float32)
    return np.asarray((counts / t) @ p["w_out"]), np.asarray(adc / t)


@pytest.mark.parametrize("case", list(STEP_CFGS))
@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
def test_step_path_matches_jax_step_harness(case, noisy):
    jcfg, tcfg, p = _model(**STEP_CFGS[case])
    ev = _events(3, 9, SIL["n_in"], seed=3)
    jl, jadc = _jax_step_harness(jax.tree.map(jnp.asarray, p), ev, jcfg, 77,
                                 j_ima.IMANoiseModel() if noisy else None)
    tl, tt = t_snn.forward_silicon(
        convert.snn_params_from_jax(p, "cpu"), ev, tcfg, seed=77,
        noise=t_ima.IMANoiseModel() if noisy else None, fused="step",
        device="cpu")
    np.testing.assert_array_equal(tt["adc_steps"].numpy(), jadc)
    np.testing.assert_allclose(tl.numpy(), jl, **TOL)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), np.argmax(jl, -1))


# --- the dataset -----------------------------------------------------------

@pytest.mark.parametrize("name", list(j_events.DATASETS))
def test_prototypes_equal_reference(name):
    jc, tc = j_events.DATASETS[name], t_events.DATASETS[name]
    assert jc == j_events.EventDataConfig(**tc.__dict__)
    np.testing.assert_array_equal(t_events._prototypes(tc),
                                  j_events._prototypes(jc))
    ds = t_events.EventDataset(tc, device="cpu")
    np.testing.assert_array_equal(ds.protos.numpy(),
                                  np.asarray(j_events.EventDataset(jc).protos))


@pytest.mark.parametrize("name", list(j_events.DATASETS))
def test_samples_match_reference_distribution(name):
    jc, tc = j_events.DATASETS[name], t_events.DATASETS[name]
    ds = t_events.EventDataset(tc, device="cpu")
    ev, lab = ds.sample(torch.Generator().manual_seed(0), 2048)
    assert ev.shape == (2048, tc.n_steps, tc.n_in)
    assert ev.dtype == torch.float32
    assert set(torch.unique(ev).tolist()) <= {-1.0, 0.0, 1.0}
    assert lab.min() >= 0 and lab.max() < tc.n_classes
    assert len(torch.unique(lab)) == tc.n_classes
    want = j_events.EventDataset(jc).measured_rate(jax.random.PRNGKey(0),
                                                   2048)
    got = ds.measured_rate(torch.Generator().manual_seed(1), 2048)
    assert abs(got - want) < 0.1 * want, (got, want)
