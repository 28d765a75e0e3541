"""The reference's last public functions in the port, against the JAX
package on the CPU.

``core.prbs.prbs_bits`` (and the ``width`` / ``taps`` keywords of the LFSR),
``core.ternary``'s ``ternary_quantize``, ``ternary_ste`` (forward and
gradient) and ``unpack_ternary``, and ``kernels.ref``'s step oracles
(``counter_snl_noise``, ``fused_head_ref``, ``fused_macro_step_ref``) and
tiled oracles (``tiled_ternary_mac_ref``, ``fused_macro_tiled_ref``), all bit
for bit.  The reference's step oracle is compiled here (``jax.jit``), as its
kernel and its sequence oracle (inside ``lax.scan``) are: XLA then
contracts the LIF's ``beta * v + drive`` and the NLD soma sum into fused
multiply-adds, as the port does.

The kernel-level ``kernels.fused_macro.fused_macro_step`` on CPU tensors
equals the step oracle, and iterated over T with ``step_offset=t`` equals
one ``fused_macro_seq`` call.  ``forward_silicon``'s per-call ``mode`` and
``mac_telemetry``: the composed path against JAX's bit for bit (spike
counts through an identity readout, and telemetry), the kernel paths
against the same call on a config whose own mode it is, and the stack
cases that raise.  Last, a guard that reads both packages with ``ast``:
every public top-level function and class of a reference module has a
namesake in the port's module of the same path, but for three named
counterparts.
"""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dendrite as j_dend
from repro.core import ima as j_ima
from repro.core import macro as j_macro
from repro.core import prbs as j_prbs
from repro.core import ternary as j_ternary
from repro.kernels import ref as j_ref
from repro.models import snn as j_snn
from repro_torch import convert
from repro_torch.core import ima as t_ima
from repro_torch.core import prbs as t_prbs
from repro_torch.core import ternary as t_ternary
from repro_torch.kernels import fused_macro as t_fused
from repro_torch.kernels import ref as t_ref
from repro_torch.models import snn as t_snn

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parent.parent / "src"


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _equal(want, got, name=""):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.dtype == got.dtype, (name, want.dtype, got.dtype)
    np.testing.assert_array_equal(_bits(want), _bits(got), err_msg=name)


# --- core.prbs -------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 1000, 32767])
@pytest.mark.parametrize("width", [15, 7])
def test_prbs_bits_bit_for_bit(width, n):
    """Width 15 gathers from the precomputed cycle; width 7 steps the
    register, whose default taps never see bits 14 and 13 there, so it
    shifts itself to 0 in the reference and in the port alike."""
    for seed in (1, 12345):
        js = j_prbs.lfsr_init(seed, width)
        ts = t_prbs.lfsr_init(seed, width)
        assert int(js) == ts
        jf, jb = j_prbs.prbs_bits(js, n, width)
        tf, tb = t_prbs.prbs_bits(ts, n, width, device="cpu")
        assert int(jf) == int(tf)
        _equal(jb, tb, f"seed {seed}")
        assert tb.shape == (n,)
    if width == 7 and n >= 1000:
        assert int(tf) == 0 and int(tb[-10:].sum()) == 0


def test_prbs_off_cycle_states_and_taps():
    """The all-zero and out-of-range states step the register at width 15;
    other taps (a maximal PRBS-7) and ``prbs_noise``'s width too."""
    for state in (0, 40000, 32767, 65535):
        jf, jb = j_prbs.prbs_bits(jnp.uint32(state), 60)
        tf, tb = t_prbs.prbs_bits(state, 60)
        assert int(jf) == int(tf), state
        _equal(jb, tb, str(state))
        tf2, tb2 = t_prbs.prbs_bits(torch.tensor([state]), 60)
        assert int(tf2) == int(tf) and torch.equal(tb2, tb)
    js, ts = jnp.uint32(77), 77
    for _ in range(200):
        js, jb = j_prbs.lfsr_step(js, 7, (7, 6))
        ts, tb = t_prbs.lfsr_step(ts, 7, (7, 6))
        assert (int(js), int(jb)) == (ts, tb)
    for width in (15, 9):
        s0 = j_prbs.lfsr_init(5, width)
        jf, jn = j_prbs.prbs_noise(s0, (3, 7), 0.05, width)
        tf, tn = t_prbs.prbs_noise(int(s0), (3, 7), 0.05, width=width)
        assert int(jf) == int(tf)
        _equal(jn, tn, f"noise width {width}")


# --- core.ternary ----------------------------------------------------------

def _ternary_inputs():
    rs = np.random.RandomState(0)
    x = rs.uniform(-2.0, 2.0, (6, 8)).astype(np.float32)
    # both edges: the threshold is strict (0.5 -> 0) and the STE window
    # inclusive (1.5 passes the gradient)
    x[0] = [0.5, -0.5, 1.5, -1.5, 0.0, -0.0, 0.5000001, 1.5000001]
    x[1] = [0.25, -0.75, 0.75, -1.0, 3.0, -3.0, 1.4999999, -0.4999999]
    per_channel = rs.uniform(0.5, 1.5, (1, 8)).astype(np.float32)
    per_channel[0, :2] = [0.5, 2.0]
    g = rs.normal(size=x.shape).astype(np.float32)
    return x, per_channel, g


@pytest.mark.parametrize("scale", ["one", "float", "per_channel"])
def test_ternary_quantize_and_ste_bit_for_bit(scale):
    x, per_channel, g = _ternary_inputs()
    if scale == "per_channel":
        js, ts = jnp.asarray(per_channel), torch.from_numpy(per_channel)
    else:
        js = ts = 1.0 if scale == "one" else 0.7
    for threshold in (0.5, 0.25):
        _equal(j_ternary.ternary_quantize(jnp.asarray(x), js, threshold),
               t_ternary.ternary_quantize(torch.from_numpy(x), ts,
                                          threshold), f"t={threshold}")
    _equal(j_ternary.ternary_ste(jnp.asarray(x), js),
           t_ternary.ternary_ste(torch.from_numpy(x), ts), "ste forward")
    xt = torch.from_numpy(x.copy()).requires_grad_()
    if scale == "per_channel":
        jgx, jgs = jax.grad(
            lambda a, s: jnp.sum(j_ternary.ternary_ste(a, s) * g),
            argnums=(0, 1))(jnp.asarray(x), js)
        st = ts.clone().requires_grad_()
        (t_ternary.ternary_ste(xt, st) * torch.from_numpy(g)).sum().backward()
        _equal(jgs, st.grad, "d scale")
        assert not st.grad.any()
    else:
        jgx = jax.grad(lambda a: jnp.sum(
            j_ternary.ternary_ste(a, js) * g))(jnp.asarray(x))
        (t_ternary.ternary_ste(xt, ts) * torch.from_numpy(g)).sum().backward()
    _equal(jgx, xt.grad, "d x")
    if scale == "one":
        # 1.5 passes the gradient, 1.5000001 does not; 0.5 is a zero
        assert (xt.grad[0, 2:4] != 0).all() and xt.grad[0, 7] == 0
        assert float(t_ternary.ternary_quantize(xt.detach(), 1.0)[0, 0]) == 0


def test_unpack_ternary_bit_for_bit():
    rs = np.random.RandomState(1)
    v = rs.randint(-1, 2, (5, 9)).astype(np.float32)
    packed = j_ternary.pack_ternary(jnp.asarray(v))
    tpacked = t_ternary.pack_ternary(torch.from_numpy(v))
    _equal(packed, tpacked, "pack")
    for jd, td in ((jnp.float32, torch.float32), (jnp.int32, torch.int32)):
        _equal(j_ternary.unpack_ternary(packed, jd),
               t_ternary.unpack_ternary(tpacked, td), str(td))
    assert t_ternary.unpack_ternary(tpacked).dtype == torch.float32


# --- kernels.ref: the step and tiled oracles --------------------------------

LIF = dict(drive_gain=0.25, beta=0.9, v_th1=1.0, v_th2=0.6, v_reset=0.0,
           v_lim=8.0)
_STATIC = ("mode", "k", "drive_gain", "beta", "v_th1", "v_th2", "v_reset",
           "v_lim", "use_snl", "ima_noise", "snl_amp")
J_STEP = jax.jit(j_ref.fused_macro_step_ref,
                 static_argnames=_STATIC + ("ratio",))
J_TILED = jax.jit(j_ref.fused_macro_tiled_ref,
                  static_argnames=_STATIC + ("ratio", "bk", "bn"))
J_HEAD = jax.jit(j_ref.fused_head_ref, static_argnames=_STATIC)


def _kwn_case(m, kdim, n, seed=0, density=0.3):
    """KWN operands as numpy arrays: x, msb, lsb, boundaries, levels,
    scale, v, the PRBS SNL tensor, and the kernel noise (JAX's and the
    port's)."""
    rs = np.random.RandomState(seed)
    w = rs.randint(-3, 4, (kdim, n)).astype(np.float32)
    msb = np.clip(np.round(w / 2.0), -1, 1).astype(np.int8)
    lsb = (w - 2.0 * msb).astype(np.int8)
    x = rs.choice([-1.0, 0.0, 1.0], p=[density / 2, 1 - density,
                                       density / 2],
                  size=(m, kdim)).astype(np.float32)
    jcb = j_ima.nlq_codebook(5, -24.0, 24.0)
    tcb = t_ima.nlq_codebook(5, -24.0, 24.0)
    _equal(jcb.levels, tcb.levels, "levels")
    scale = rs.uniform(0.05, 0.3, n).astype(np.float32)
    v = rs.uniform(-1.0, 1.2, (m, n)).astype(np.float32)
    _, bits = t_prbs.draw(torch.tensor([t_prbs.lfsr_init(1)]), m * n)
    nz = t_prbs.bits_to_noise(bits[0], 0.05).reshape(m, n).numpy()
    jkn = j_ima.kernel_noise_params(j_ima.IMANoiseModel(), jcb)
    tkn = t_ima.kernel_noise_params(t_ima.IMANoiseModel(), tcb)
    assert tuple(jkn) == tuple(tkn)
    ops = (x, msb, lsb, np.asarray(jcb.boundaries), np.asarray(jcb.levels),
           scale, v)
    return ops, nz, jkn, tkn


def _nld_case(m, kdim, n, n_branches, activation, seed=0, density=0.3):
    """NLD operands (packed through the reference's ``pack_nld_weights``)
    and the kernel noise."""
    rs = np.random.RandomState(seed)
    mcfg = j_macro.CIMMacroConfig(code_bits=5, mac_range=4.0,
                                  ima_noise=j_ima.IMANoiseModel())
    fw = j_macro.pack_nld_weights(
        j_dend.dendrite_init(jax.random.PRNGKey(seed + 1), kdim, n,
                             n_branches), mcfg, activation=activation)
    x = rs.choice([-1.0, 0.0, 1.0], p=[density / 2, 1 - density,
                                       density / 2],
                  size=(m, kdim)).astype(np.float32)
    v = rs.uniform(-1.0, 1.2, (m, n)).astype(np.float32)
    ops = (x, np.asarray(fw.msb), np.asarray(fw.lsb),
           np.asarray(fw.boundaries), np.asarray(fw.levels),
           np.asarray(fw.scale), v)
    kn = j_macro.fused_kernel_noise(fw, mcfg)
    return ops, np.asarray(fw.w_dend), kn


def _case(mode, noisy, m=9, kdim=70, n=40, seed=0):
    """(numpy operands, noise tensor or None, w_dend or None, JAX keywords,
    port keywords) of one step."""
    if mode == "kwn":
        ops, nz, jkn, tkn = _kwn_case(m, kdim, n, seed)
        w_dend = None
        kw = dict(LIF, k=6)
    else:
        ops, w_dend, jkn = _nld_case(m, kdim, n, 2 + seed % 2, "relu", seed)
        tkn, nz = jkn, None
        kw = dict(LIF)
    jkw, tkw = dict(kw, mode=mode), dict(kw, mode=mode)
    if noisy:
        nz = None
        jkw.update(ima_noise=jkn, snl_amp=0.05, seed=918273 + seed,
                   step=7 + seed)
        tkw.update(ima_noise=tkn, snl_amp=0.05, seed=918273 + seed,
                   step=7 + seed)
    return ops, nz, w_dend, jkw, tkw


def _jax_args(ops, nz, w_dend):
    return tuple(jnp.asarray(a) for a in ops) + (
        None if nz is None else jnp.asarray(nz),
        None if w_dend is None else jnp.asarray(w_dend))


def _torch_args(ops, nz, w_dend):
    return tuple(torch.from_numpy(np.array(a)) for a in ops) + (
        None if nz is None else torch.from_numpy(nz),
        None if w_dend is None else torch.from_numpy(np.array(w_dend)))


NAMES = ("mac", "v_out", "spikes", "mask", "adc_steps")


def _all_equal(want, got, tag):
    assert len(want) == len(got)
    for name, a, b in zip(NAMES[-len(want):], want, got):
        _equal(a, b, f"{tag} {name}")


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
@pytest.mark.parametrize("mode", ["kwn", "nld"])
def test_step_oracle_bit_for_bit(mode, noisy):
    ops, nz, w_dend, jkw, tkw = _case(mode, noisy)
    want = J_STEP(*_jax_args(ops, nz, w_dend), **jkw)
    got = t_ref.fused_macro_step_ref(*_torch_args(ops, nz, w_dend), **tkw)
    _all_equal(want, got, f"{mode} step")
    assert float(np.asarray(want[2]).sum()) > 0          # something fired
    head = J_HEAD(want[0], *_jax_args(ops, nz, w_dend)[3:], **jkw)
    t_head = t_ref.fused_head_ref(got[0], *_torch_args(ops, nz, w_dend)[3:],
                                  **tkw)
    _all_equal(head, t_head, f"{mode} head")


def test_step_oracle_noise_moves_the_result():
    """The noisy step differs from the clean one in both modes: the
    counter streams reach the codes (and the KWN membrane)."""
    for mode in ("kwn", "nld"):
        clean, noisy = (t_ref.fused_macro_step_ref(
            *_torch_args(*case[:3]), **case[4])
            for case in (_case(mode, False), _case(mode, True)))
        assert not torch.equal(clean[1], noisy[1]), mode


def test_counter_snl_noise_bit_for_bit():
    for shape, seed, step in (((5, 17), 0, 0), ((13, 128), 424242, 9),
                              ((1, 1000), 2 ** 31 - 1, 12345)):
        want = j_ref.counter_snl_noise(shape, seed, step, 0.05)
        got = t_ref.counter_snl_noise(shape, seed, step, 0.05)
        _equal(want, got, str(shape))
        assert (np.abs(np.asarray(want)) == np.float32(0.05)).all()
    # per-row words: row i replays the stream of row rows[i]
    rows = torch.tensor([[3], [0], [7]])
    got = t_ref.counter_snl_noise((3, 20), 11, 4, 0.5, rows=rows)
    full = t_ref.counter_snl_noise((8, 20), 11, 4, 0.5)
    assert torch.equal(got, full[[3, 0, 7]])


# (bk, bn): the defaults, tiles that divide, and ragged last tiles in K,
# in NC and in both
TILINGS = [(256, 128), (32, 16), (35, 16), (32, 13), (23, 7), (70, 40),
           (1, 200)]


@pytest.mark.parametrize("mode", ["kwn", "nld"])
def test_tiled_oracles_bit_for_bit(mode):
    """Every tiling of the MAC equals the untiled step oracle, clean and
    noisy; the tiled MAC equals JAX's at each tiling, and the whole tiled
    oracle JAX's at a ragged one."""
    for noisy in (False, True):
        ops, nz, w_dend, jkw, tkw = _case(mode, noisy, seed=3)
        targs, jargs = _torch_args(ops, nz, w_dend), _jax_args(ops, nz,
                                                              w_dend)
        step = t_ref.fused_macro_step_ref(*targs, **tkw)
        for bk, bn in TILINGS:
            tag = f"{mode} noisy={noisy} bk={bk} bn={bn}"
            got = t_ref.fused_macro_tiled_ref(*targs, bk=bk, bn=bn, **tkw)
            _all_equal(step, got, tag)
            if not noisy and bk > 1:
                _equal(j_ref.tiled_ternary_mac_ref(*jargs[:3], bk=bk, bn=bn),
                       t_ref.tiled_ternary_mac_ref(*targs[:3], bk=bk, bn=bn),
                       tag)
        _all_equal(J_TILED(*jargs, bk=23, bn=7, **jkw),
                   t_ref.fused_macro_tiled_ref(*targs, bk=23, bn=7, **tkw),
                   f"{mode} noisy={noisy} JAX tiled")


# --- kernels.fused_macro.fused_macro_step ---------------------------------

def _padded(mode, m=8, kdim=128, n=40, seed=5):
    """Operands padded to bm=8, bk=128 as torch tensors, and the shared
    keywords of the step and its oracle."""
    ops, nz, w_dend, _, tkw = _case(mode, True, m=m, kdim=kdim, n=n,
                                    seed=seed)
    args = _torch_args(ops, nz, w_dend)
    tkw.pop("step")
    return args, tkw


@pytest.mark.parametrize("mode", ["kwn", "nld"])
def test_kernel_step_on_cpu_equals_oracle_and_iterates_to_seq(mode):
    """On CPU tensors the kernel-level step is the plain version: equal to
    the step oracle, the launch counters untouched; iterated over T with
    ``step_offset=t`` it equals one sequence call."""
    args, kw = _padded(mode)
    x, msb, lsb, bounds, levels, scale, v, nz, w_dend = args
    rs = np.random.RandomState(8)
    t_steps, m, kdim = 5, x.shape[0], x.shape[1]
    xs = torch.from_numpy(rs.choice([-1.0, 0.0, 1.0], p=[0.15, 0.7, 0.15],
                                    size=(t_steps, m, kdim))
                          .astype(np.float32))
    counters = (t_fused.fused_macro_seq.launches,
                t_fused.fused_macro_seq_nld.launches)
    step_kw = dict(kw, bm=8, bk=128, device="cpu")
    vt, outs = v, []
    for t in range(t_steps):
        got = t_fused.fused_macro_step(xs[t], msb, lsb, bounds, levels,
                                       scale, vt, None, w_dend,
                                       step_offset=t, **step_kw)
        oracle = t_ref.fused_macro_step_ref(
            xs[t], msb, lsb, bounds, levels, scale, vt, None, w_dend,
            step=t, **kw)
        _all_equal([a.numpy() for a in oracle], got, f"{mode} t={t}")
        assert got[4].shape == (m, 1) and got[4].dtype == torch.int32
        outs.append(got)
        vt = got[1]
    xi = xs.to(torch.int8)
    lif = {k: kw[k] for k in ("drive_gain", "beta", "v_th1", "v_reset",
                              "v_lim")}
    if mode == "kwn":
        seq = t_fused.fused_macro_seq(
            xi, msb, lsb, bounds, levels, scale, v, None, None, None,
            k=kw["k"], v_th2=kw["v_th2"], ima_noise=kw["ima_noise"],
            snl_amp=kw["snl_amp"], seed=kw["seed"], bm=8, bk=128, **lif)
    else:
        seq = t_fused.fused_macro_seq_nld(
            xi, msb, lsb, bounds, levels, scale, w_dend, v, None, None,
            ima_noise=kw["ima_noise"], seed=kw["seed"], bm=8, bk=128, **lif)
    for i, name in enumerate(NAMES):
        if name == "v_out":
            _equal(seq[1].numpy(), vt, "v_out")
        else:
            _equal(seq[i].numpy(), torch.stack([o[i] for o in outs]), name)
    assert (t_fused.fused_macro_seq.launches,
            t_fused.fused_macro_seq_nld.launches) == counters
    quiet = t_fused.fused_macro_step(xs[0], msb, lsb, bounds, levels, scale,
                                     v, None, w_dend, mac_telemetry=False,
                                     **step_kw)
    assert quiet[0] is None and torch.equal(quiet[1], outs[0][1])


def test_kernel_step_refuses_unpadded_operands():
    args, kw = _padded("kwn")
    x, msb, lsb, bounds, levels, scale, v, _, _ = args
    with pytest.raises(ValueError, match="not padded"):
        t_fused.fused_macro_step(x, msb, lsb, bounds, levels, scale, v,
                                 bm=16, bk=128, device="cpu", **kw)
    with pytest.raises(ValueError, match="not padded"):
        t_fused.fused_macro_step(x, msb, lsb, bounds, levels, scale, v,
                                 bm=8, bk=128, bn=32, device="cpu", **kw)
    with pytest.raises(ValueError, match="columns"):
        t_fused.fused_macro_step(x, msb, lsb, bounds, levels, scale,
                                 v[:, :20], bm=8, bk=128, device="cpu", **kw)


# --- models.snn.forward_silicon(mode=..., mac_telemetry=...) ---------------

KW = dict(n_in=64, n_hidden=24, n_classes=24, n_steps=10, k=5,
          n_branches=2, activation="relu", dend_range=4.0)
TELE = ("adc_steps", "lif_updates", "sops")


def _both_params(seed=0):
    """The reference's KWN ``init_params`` plus NLD branch weights on
    multiples of 2^-6 (every partial sum exact, so the composed NLD MACs
    are bit for bit across the libraries) and an identity readout (the
    logits are the spike rates exactly): a dict that holds ``w_hid`` and
    ``dend``."""
    jcfg = j_snn.SNNConfig(**KW)
    p = {k: np.asarray(a) for k, a in
         j_snn.init_params(jcfg, jax.random.PRNGKey(seed)).items()}
    rs = np.random.RandomState(seed + 9)
    j, i, n = KW["n_branches"], KW["n_in"], KW["n_hidden"]
    mask = (rs.uniform(size=(j, i, n)) < 0.5).astype(np.float32)
    w_syn = rs.randint(-64, 65, (j, i, n)).astype(np.float32) / 64.0 * mask
    w_dend = rs.choice([-1.0, -0.5, 0.5, 1.0], (j, n)).astype(np.float32)
    p["dend"] = j_dend.DendriteParams(w_syn, w_dend, mask)
    p["w_out"] = np.eye(n, dtype=np.float32)
    return p


def _events(b, t, seed=0, rate=0.3):
    rs = np.random.RandomState(seed)
    return rs.choice([-1.0, 0.0, 1.0], p=[rate / 2, 1 - rate, rate / 2],
                     size=(b, t, KW["n_in"])).astype(np.float32)


def _jax_tree(p):
    return {k: (j_dend.DendriteParams(*map(jnp.asarray, a))
                if isinstance(a, j_dend.DendriteParams) else jnp.asarray(a))
            for k, a in p.items()}


def test_snn_params_from_jax_converts_w_hid_and_dend():
    p = _both_params()
    tp = convert.snn_params_from_jax(p, "cpu")
    assert set(tp) == {"w_out", "w_hid", "dend"}
    assert np.array_equal(tp["w_hid"].numpy(), p["w_hid"])
    assert np.array_equal(tp["dend"].w_syn.numpy(), p["dend"].w_syn)


@pytest.mark.parametrize("own,mode", [("kwn", "nld"), ("nld", "kwn"),
                                      ("kwn", None)])
def test_composed_mode_override_bit_for_bit(own, mode):
    """``forward_silicon(mode=..., fused=False)`` against JAX's composed
    path with the same override: rates and telemetry bit for bit."""
    p = _both_params()
    jcfg = j_snn.SNNConfig(**KW, mode=own)
    tcfg = t_snn.SNNConfig(**KW, mode=own)
    ev = _events(3, 9, seed=2)
    jl, jt = j_snn.forward_silicon(_jax_tree(p), jnp.asarray(ev), jcfg,
                                   jax.random.PRNGKey(1), mode=mode,
                                   fused=False)
    tl, tt = t_snn.forward_silicon(convert.snn_params_from_jax(p, "cpu"),
                                   ev, tcfg, device="cpu", fused=False,
                                   mode=mode)
    _equal(jl, tl, "rates")
    for key in TELE:
        _equal(jt[key], tt[key], key)
    assert np.asarray(jl).sum() > 0
    ran = mode or own
    assert float(tt["lif_updates"][0]) == (KW["k"] if ran == "kwn"
                                           else KW["n_hidden"])


@pytest.mark.parametrize("own,mode", [("kwn", "nld"), ("nld", "kwn")])
def test_kernel_paths_mode_override_and_mac_telemetry(own, mode):
    """``"seq"`` and ``"step"`` with an overriding ``mode`` equal the same
    call on a config whose own mode it is, clean and noisy; and
    ``mac_telemetry=True`` leaves logits and telemetry as they were."""
    tp = convert.snn_params_from_jax(_both_params(1), "cpu")
    cfg = t_snn.SNNConfig(**KW, mode=own)
    native = dataclasses.replace(cfg, mode=mode)
    ev = _events(2, 7, seed=4)
    for noise in (None, t_ima.IMANoiseModel()):
        for fused in ("seq", "step"):
            kw = dict(seed=31, noise=noise, fused=fused, device="cpu")
            wl, wt = t_snn.forward_silicon(tp, ev, native, **kw)
            for tele in (False, True):
                gl, gt = t_snn.forward_silicon(tp, ev, cfg, mode=mode,
                                               mac_telemetry=tele, **kw)
                tag = f"{fused} noise={noise is not None} tele={tele}"
                assert torch.equal(wl, gl), tag
                assert set(wt) == set(gt), tag
                for key in wt:
                    assert torch.equal(wt[key], gt[key]), (tag, key)
            assert wl.sum() > 0
    # the override ran the other head: the config's own mode differs
    own_l, _ = t_snn.forward_silicon(tp, ev, cfg, device="cpu")
    assert not torch.equal(own_l, wl)


def test_stack_overrides_raise():
    kw = dict(n_in=32, n_classes=4, hidden_layers=(16, 12), k_layers=(4, 3))
    cfg = t_snn.SNNConfig(**kw)
    p = t_snn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ev = _events(1, 3)[..., :32]
    with pytest.raises(ValueError, match="KWN-only"):
        t_snn.forward_silicon(p, ev, cfg, mode="nld", device="cpu")
    with pytest.raises(ValueError, match="KWN-only"):
        t_snn.forward_silicon(p, ev, cfg, mode="nld", fused=False,
                              device="cpu")
    for fused in ("seq", "step", True):
        with pytest.raises(ValueError, match="mac_telemetry"):
            t_snn.forward_silicon(p, ev, cfg, mac_telemetry=True,
                                  fused=fused, device="cpu")
    # the reference's composed stack ignores mac_telemetry, and so does
    # the port's
    a = t_snn.forward_silicon(p, ev, cfg, mac_telemetry=True, fused=False,
                              device="cpu")
    b = t_snn.forward_silicon(p, ev, cfg, fused=False, device="cpu")
    assert torch.equal(a[0], b[0])
    jcfg = j_snn.SNNConfig(**kw)
    with pytest.raises(ValueError):
        j_snn.forward_silicon({}, jnp.asarray(ev), jcfg,
                              jax.random.PRNGKey(0), mode="nld")


# --- the coverage guard ---------------------------------------------------

# Reference names whose port counterpart carries another name (or none):
# the JAX shim, and two JAX/XLA artefacts.
COUNTERPARTS = {
    "compat.py": None,        # the JAX version shim: nothing to port
    "nn/module.py::abstract": "launch/dryrun.py::abstract_params",
    "roofline/analysis.py::from_compiled": "roofline/analysis.py::"
                                           "from_counts",
}


def _public(path: Path) -> set:
    tree = ast.parse(path.read_text())
    return {node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef))
            and not node.name.startswith("_")}


def test_every_public_reference_name_has_a_port_counterpart():
    ref_root, port_root = SRC / "repro", SRC / "repro_torch"
    missing, excused = [], set()
    for path in sorted(ref_root.rglob("*.py")):
        rel = path.relative_to(ref_root).as_posix()
        names = _public(path)
        if rel in COUNTERPARTS:
            excused.add(rel)
            continue
        port = port_root / rel
        have = _public(port) if port.exists() else set()
        for name in sorted(names - have):
            key = f"{rel}::{name}"
            if key not in COUNTERPARTS:
                missing.append(key)
                continue
            excused.add(key)
            mod, other = COUNTERPARTS[key].split("::")
            assert other in _public(port_root / mod), key
    assert not missing, missing
    assert excused == set(COUNTERPARTS)
