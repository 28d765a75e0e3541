"""The reference's calling conventions in the port.

A guard read from both source trees by ``ast`` (the reference's
``launch/dryrun.py`` cannot be imported): every public function, method
and NamedTuple / dataclass field of each module of ``src/repro/`` takes,
in the port's module of that path, every parameter the reference's takes,
positional ones in the reference's order, shared defaults equal by value.
The exceptions, each with its reason, are ``EXCEPTIONS``; an exception no
longer needed fails too.

Then the paths those parameters open, against the JAX package on the CPU
with operands from ``numpy.random.RandomState``: ``dendrite_mac`` in every
combination of ``f``, ``nl_cb`` and ``quantize``; ``fused_seq_vjp`` at
``surrogate_beta=2.0`` against ``jax.grad`` of the reference's pure-jnp
``fused_macro_seq_vjp_ref``; the reference-convention oracles
``fused_macro_seq_ref`` and ``fused_macro_multi_seq_ref`` called as the
reference's fused-macro benchmark calls them, bit for bit; the
kernel-level ``fused_macro_seq(mode="nld")`` through its plain version;
and the engine's per-step cadence (``SNNEventEngine(time_major=False)``)
bit for bit against the time-major drain path.
"""

import ast
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dendrite as j_dend
from repro.core import ima as j_ima
from repro.kernels import ref as j_ref
from repro.models import snn as j_snn
from repro.serve import engine as j_engine
from repro_torch import convert
from repro_torch.core import dendrite as t_dend
from repro_torch.core import ima as t_ima
from repro_torch.core import macro as t_macro
from repro_torch.kernels import fused_macro as t_fused
from repro_torch.kernels import ref as t_ref
from repro_torch.models import snn as t_snn
from repro_torch.serve import engine as t_engine

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"

# --- the guard ------------------------------------------------------------

_KEY = "a JAX PRNG key; the port draws from"
_BLOCK = "a Pallas block pin; the CUDA kernel has no such tile"
_INTERP = "Pallas interpret mode; a CPU tensor runs the plain version"
_GUMBEL = "a JAX PRNG key; the port takes the SNL rescue's Gumbel draw"

# ``path::Name(param)``: the parameter is dropped (None) or replaced by the
# port's parameter named in the value, in the same place.
# ``path::Name(param=)``: the port's default differs (the value is the
# port's default).  ``path::Class.method``: the method has no counterpart.
# A NamedTuple's or dataclass's fields are its constructor's parameters.
EXCEPTIONS = {
    "core/dendrite.py::dendrite_init(key)":
        ("generator", f"{_KEY} a torch.Generator"),
    "core/ima.py::ima_convert_noisy(key)":
        ("generator", f"{_KEY} a torch.Generator"),
    "core/ima.py::measure_transfer_error(key)":
        ("generator", f"{_KEY} a torch.Generator"),
    "core/ima.py::measure_inl(key)":
        ("generator", f"{_KEY} a torch.Generator"),
    "core/macro.py::cim_mac(key)":
        ("generator", f"{_KEY} a torch.Generator"),
    "core/macro.py::kwn_forward(key)":
        ("generator", f"{_KEY} a torch.Generator"),
    "core/ternary.py::sample_current_ratio(key)":
        ("generator", f"{_KEY} a torch.Generator"),
    "core/ternary.py::effective_weights(key)":
        ("generator", f"{_KEY} a torch.Generator"),
    "data/events.py::EventDataset.sample(key)":
        ("generator", f"{_KEY} a torch.Generator"),
    "data/events.py::EventDataset.measured_rate(key)":
        ("generator", f"{_KEY} a torch.Generator"),
    "models/snn.py::init_params(key)":
        ("generator", f"{_KEY} a torch.Generator"),
    "models/snn.py::evaluate(key)":
        ("generator", f"{_KEY} a torch.Generator"),
    "models/snn.py::forward_silicon(key)":
        ("seed", f"{_KEY} the int counter seed it keys"),
    "models/snn.py::forward_silicon(fused=)":
        ("'seq'", "the kernels, the port's main path; the reference: False"),
    "nn/module.py::materialize(key)":
        ("generator", f"{_KEY} a torch.Generator"),
    "nn/moe.py::router_topk(rng)": ("gumbel", _GUMBEL),
    "nn/moe.py::moe_ref(rng)": ("gumbel", _GUMBEL),
    "nn/moe.py::moe_a2a(rng)": ("gumbel", _GUMBEL),
    "nn/moe.py::moe_2d(rng)": ("gumbel", _GUMBEL),
    "nn/moe.py::moe_dense_ep_2d(rng)": ("gumbel", _GUMBEL),
    "nn/moe.py::moe_dense_ep(rng)": ("gumbel", _GUMBEL),
    "serve/engine.py::EventRequest(key)":
        ("seed", f"{_KEY} the int counter seed it keys"),
    "train/silicon.py::step_seed(key)":
        ("generator", f"{_KEY} a torch.Generator"),
    "tune/measure.py::event_stream(key)":
        ("rs", f"{_KEY} a numpy RandomState (or its seed)"),
    "kernels/ops.py::fused_macro_seq_vjp(seed_f)":
        ("seed", "custom_vjp wants a float primal; the port takes the int"),
    "kernels/flash_attention.py::flash_attention_fwd(interpret)":
        (None, _INTERP),
    "kernels/fused_macro.py::fused_macro_seq(bn)": (None, _BLOCK),
    "kernels/fused_macro.py::fused_macro_seq(interpret)": (None, _INTERP),
    "kernels/fused_macro.py::fused_macro_step(interpret)": (None, _INTERP),
    "kernels/fused_macro.py::fused_macro_multi_seq(has_noise)":
        (None, "derived from the operands (noises is None or not)"),
    "kernels/fused_macro.py::fused_macro_multi_seq(gated)":
        (None, "derived from the operands (activity is None or not)"),
    "kernels/fused_macro.py::fused_macro_multi_seq(interpret)":
        (None, _INTERP),
    "kernels/fused_macro.py::LayerSpec(bn)": (None, _BLOCK),
    "kernels/fused_macro.py::TilePlan.vmem_resident_bytes":
        (None, "a TPU VMEM budget; the card's tiles are planned otherwise"),
    "kernels/fused_macro.py::TilePlan.activity_bytes":
        (None, "a TPU scalar-prefetch budget of that VMEM estimate"),
    "kernels/fused_macro_grad.py::fused_macro_seq_grad(bm)": (None, _BLOCK),
    "kernels/fused_macro_grad.py::fused_macro_seq_grad(bn)": (None, _BLOCK),
    "kernels/fused_macro_grad.py::fused_macro_seq_grad(interpret)":
        (None, _INTERP),
    "kernels/kwn_topk.py::kwn_topk(bm)": (None, _BLOCK),
    "kernels/kwn_topk.py::kwn_topk(interpret)": (None, _INTERP),
    "kernels/lif_step.py::lif_step_fused(bm)": (None, _BLOCK),
    "kernels/lif_step.py::lif_step_fused(interpret)": (None, _INTERP),
    "kernels/nlq_lut.py::nlq_convert(bm)": (None, _BLOCK),
    "kernels/nlq_lut.py::nlq_convert(interpret)": (None, _INTERP),
    "kernels/ops.py::ternary_mac(bm)": (None, _BLOCK),
    "kernels/ops.py::ternary_mac(bn)": (None, _BLOCK),
    "kernels/ops.py::ternary_mac(bk)": (None, _BLOCK),
    "kernels/ops.py::SeqVJPSpec(has_noise)":
        (None, "derived from the operands (noise is None or not)"),
    "kernels/ternary_mac.py::ternary_mac(bm)": (None, _BLOCK),
    "kernels/ternary_mac.py::ternary_mac(bn)": (None, _BLOCK),
    "kernels/ternary_mac.py::ternary_mac(bk)": (None, _BLOCK),
    "kernels/ternary_mac.py::ternary_mac(interpret)": (None, _INTERP),
    "obs/trace.py::Tracer.__init__(jax_annotations)":
        (None, "jax.profiler annotations; the port's spans are its own"),
    "roofline/analysis.py::collective_bytes(hlo)":
        ("tally", "XLA HLO text; the port reads a tally of its collectives"),
    "train/optim.py::adamw_update(scan_subtrees)":
        (None, "bounds XLA's temporaries by lax.scan; eager goes by leaf"),
}

_FRAMEWORK = ("jnp.", "np.", "torch.", "jax.numpy.")


def _is_record(cls: ast.ClassDef) -> bool:
    return any("NamedTuple" in ast.unparse(b) for b in cls.bases) or any(
        "dataclass" in ast.unparse(d) for d in cls.decorator_list)


def _constants(tree: ast.Module) -> dict:
    """Module-level ``NAME = literal`` assignments."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


class _Sig:
    """Parameters of a callable: positional names, keyword-only names,
    defaults by name (source text), and whether it takes *args / **kw."""

    def __init__(self, pos, kwonly, defaults, star, dstar):
        self.pos, self.kwonly, self.defaults = pos, kwonly, defaults
        self.star, self.dstar = star, dstar

    @classmethod
    def of_function(cls, fn: ast.FunctionDef):
        a = fn.args
        pos = [x.arg for x in a.posonlyargs + a.args]
        defaults = dict(zip(pos[len(pos) - len(a.defaults):],
                            (ast.unparse(d) for d in a.defaults)))
        for x, d in zip(a.kwonlyargs, a.kw_defaults):
            if d is not None:
                defaults[x.arg] = ast.unparse(d)
        if pos and pos[0] in ("self", "cls"):
            pos = pos[1:]
        return cls(pos, [x.arg for x in a.kwonlyargs], defaults,
                   a.vararg is not None, a.kwarg is not None)

    @classmethod
    def of_record(cls, node: ast.ClassDef):
        pos, defaults = [], {}
        for st in node.body:
            if isinstance(st, ast.AnnAssign) and isinstance(st.target,
                                                            ast.Name):
                pos.append(st.target.id)
                if st.value is not None:
                    defaults[st.target.id] = ast.unparse(st.value)
        return cls(pos, [], defaults, False, False)


def _signatures(path: Path):
    """{qualified name: _Sig} of a module's public functions, its public
    classes' public methods (and ``__init__`` / ``__call__``), and its
    records' constructors; with the module's constants."""
    tree = ast.parse(path.read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and not node.name.startswith("_"):
            out[node.name] = _Sig.of_function(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            if _is_record(node):
                out[node.name] = _Sig.of_record(node)
            for st in node.body:
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and (not st.name.startswith("_")
                             or st.name in ("__init__", "__call__")):
                    out[f"{node.name}.{st.name}"] = _Sig.of_function(st)
    return out, _constants(tree)


def _value(text: str, consts: dict):
    for prefix in _FRAMEWORK:
        if text.startswith(prefix):
            return ("dtype", text[len(prefix):])
    if text in consts:
        return consts[text]
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def _compare(key: str, ref: _Sig, port: _Sig, ref_c: dict, port_c: dict,
             used: set) -> list:
    """The faults of ``port`` against ``ref``, with ``used`` collecting the
    exceptions taken."""
    faults = []
    rename = {}
    for name in ref.pos + ref.kwonly:
        exc = EXCEPTIONS.get(f"{key}({name})")
        if exc is not None:
            used.add(f"{key}({name})")
            rename[name] = exc[0]
            if exc[0] is not None and exc[0] not in port.pos + port.kwonly:
                faults.append(f"{key}: no parameter {exc[0]!r} in the "
                              f"place of {name!r}")
        elif name not in port.pos + port.kwonly:
            faults.append(f"{key}: no parameter {name!r}")
    want = [rename.get(x, x) for x in ref.pos if rename.get(x, x)]
    if port.pos[:len(want)] != want:
        faults.append(f"{key}: positional {port.pos} do not begin with the "
                      f"reference's {want}")
    for name, text in ref.defaults.items():
        if name in rename or name not in port.pos + port.kwonly:
            continue
        dkey = f"{key}({name}=)"
        if dkey in EXCEPTIONS:
            used.add(dkey)
            if port.defaults.get(name) != EXCEPTIONS[dkey][0]:
                faults.append(f"{dkey}: the port's default moved")
            continue
        if name not in port.defaults:
            faults.append(f"{key}: {name!r} has no default")
        elif _value(text, ref_c) != _value(port.defaults[name], port_c):
            faults.append(f"{key}: {name}={port.defaults[name]}, the "
                          f"reference's {text}")
    for flag in ("star", "dstar"):
        if getattr(ref, flag) and not getattr(port, flag):
            faults.append(f"{key}: no {'**' if flag == 'dstar' else '*'}"
                          f"parameter")
    return faults


def _guard_faults(exceptions_used: set) -> list:
    ref_root, port_root = SRC / "repro", SRC / "repro_torch"
    faults = []
    for path in sorted(ref_root.rglob("*.py")):
        rel = path.relative_to(ref_root).as_posix()
        port_path = port_root / rel
        if not port_path.exists():
            continue        # the names guard (test_torch_reference_surface)
        ref_sigs, ref_c = _signatures(path)
        port_sigs, port_c = _signatures(port_path)
        for name, sig in ref_sigs.items():
            key = f"{rel}::{name}"
            if name not in port_sigs:
                if "." not in name:
                    continue    # the names guard's, with its counterparts
                if key in EXCEPTIONS:
                    exceptions_used.add(key)
                else:
                    faults.append(f"{key}: no such method")
                continue
            faults += _compare(key, sig, port_sigs[name], ref_c, port_c,
                               exceptions_used)
    return faults


def test_every_reference_parameter_is_taken_by_its_namesake():
    used: set = set()
    faults = _guard_faults(used)
    assert not faults, "\n".join(faults)
    assert used == set(EXCEPTIONS), sorted(set(EXCEPTIONS) - used)
    assert all(reason for _, reason in EXCEPTIONS.values())


CUTS = [("serve/engine.py", "SNNEventEngine.__init__", "time_major"),
        ("core/dendrite.py", "dendrite_mac", "quantize"),
        ("core/macro.py", "fused_seq_vjp", "surrogate_beta"),
        ("kernels/fused_macro.py", "fused_macro_seq", "w_dend"),
        ("kernels/ref.py", "fused_macro_seq_ref", "step_offset"),
        ("kernels/ref.py", "fused_macro_multi_seq_ref", "seeds"),
        ("nn/recurrent.py", "mlstm_init_state", "dtype")]


@pytest.mark.parametrize("rel,name,param", CUTS,
                         ids=[c[2] for c in CUTS])
def test_the_guard_sees_a_missing_parameter(rel, name, param, monkeypatch):
    """Take one of the parameters this slice added out of the port's
    signature as the guard reads it: the guard fails on it."""
    real = _signatures

    def cut(path):
        sigs, consts = real(path)
        if path == SRC / "repro_torch" / rel:
            sig = sigs[name]
            sigs[name] = _Sig([x for x in sig.pos if x != param],
                              [x for x in sig.kwonly if x != param],
                              sig.defaults, sig.star, sig.dstar)
        return sigs, consts

    monkeypatch.setattr(sys.modules[__name__], "_signatures", cut)
    faults = _guard_faults(set())
    assert f"{rel}::{name}: no parameter {param!r}" in faults, faults


# --- dendrite_mac: the reference's order and its quantize flag -------------

def _dend_case():
    dp = j_dend.dendrite_init(jax.random.PRNGKey(3), 40, 12, 3)
    rs = np.random.RandomState(4)
    s = rs.choice([-1.0, 0.0, 1.0], p=[0.2, 0.6, 0.2],
                  size=(6, 40)).astype(np.float32)
    tp = convert.snn_params_from_jax({"dend": dp, "w_out": np.zeros(1)},
                                     "cpu")["dend"]
    return dp, tp, s


@pytest.mark.parametrize("act", [None, "quadratic"])
@pytest.mark.parametrize("with_cb", [False, True], ids=["no_cb", "cb"])
@pytest.mark.parametrize("quantize", [False, True])
def test_dendrite_mac_matches_reference_in_every_combination(act, with_cb,
                                                             quantize):
    """``quantize`` and ``nl_cb`` together put the branch MACs through the
    ramp; either alone leaves them to ``f``.  Float einsums: XLA and
    PyTorch sum in other orders, so equal to a few f32 ULPs."""
    dp, tp, s = _dend_case()
    jf = None if act is None else j_ima.DENDRITE_ACTIVATIONS[act]
    tf = None if act is None else t_dend.TRAIN_ACTIVATIONS[act]
    jcb = j_ima.activation_codebook(5, j_ima.relu, -4.0, 4.0) \
        if with_cb else None
    tcb = t_ima.activation_codebook(5, t_ima.relu, -4.0, 4.0) \
        if with_cb else None
    want = np.asarray(j_dend.dendrite_mac(dp, jnp.asarray(s), jf, jcb,
                                          quantize))
    got = t_dend.dendrite_mac(tp, torch.from_numpy(s), tf, tcb, quantize)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    by_name = t_dend.dendrite_mac(tp, torch.from_numpy(s), f=tf,
                                  nl_cb=tcb, quantize=quantize)
    assert torch.equal(by_name, got)
    ramp = quantize and with_cb
    plain = t_dend.dendrite_mac(tp, torch.from_numpy(s), tf)
    assert torch.equal(got, plain) != ramp


def test_dendrite_mac_codebook_alone_is_not_quantized():
    """``dendrite_mac(p, s, nl_cb=cb)`` is the float branch sum, as in the
    reference; ``dendrite_mac(p, s, f, cb, True)`` the quantized one."""
    dp, tp, s = _dend_case()
    jcb = j_ima.activation_codebook(5, j_ima.relu, -4.0, 4.0)
    tcb = t_ima.activation_codebook(5, t_ima.relu, -4.0, 4.0)
    x = torch.from_numpy(s)
    np.testing.assert_allclose(
        t_dend.dendrite_mac(tp, x, nl_cb=tcb).numpy(),
        np.asarray(j_dend.dendrite_mac(dp, jnp.asarray(s), nl_cb=jcb)),
        rtol=1e-5, atol=1e-5)
    assert torch.equal(t_dend.dendrite_mac(tp, x, nl_cb=tcb),
                       t_dend.dendrite_mac(tp, x))
    f_t = t_dend.TRAIN_ACTIVATIONS["relu"]
    np.testing.assert_allclose(
        t_dend.dendrite_mac(tp, x, f_t, tcb, True).numpy(),
        np.asarray(j_dend.dendrite_mac(dp, jnp.asarray(s), j_ima.relu, jcb,
                                       True)), rtol=1e-5, atol=1e-5)


# --- fused_seq_vjp: surrogate_beta -----------------------------------------

def _vjp_case(noisy):
    rs = np.random.RandomState(11)
    t, m, k_dim, n = 5, 12, 96, 40
    x = rs.choice([-1.0, 0.0, 1.0], p=[0.08, 0.84, 0.08],
                  size=(t, m, k_dim)).astype(np.float32)
    w = rs.randint(-3, 4, (k_dim, n)).astype(np.float32)
    scale = rs.uniform(0.05, 0.3, n).astype(np.float32)
    v = (rs.randn(m, n) * 0.5).astype(np.float32)
    g_spk = rs.randn(t, m, n).astype(np.float32)
    g_vfin = rs.randn(m, n).astype(np.float32)
    return x, w, scale, v, g_spk, g_vfin


def _port_vjp_grads(noisy, sbeta):
    x, w, scale, v, g_spk, g_vfin = _vjp_case(noisy)
    mcfg = t_macro.CIMMacroConfig(code_bits=5, mac_range=24.0,
                                  ima_noise=t_ima.IMANoiseModel()
                                  if noisy else None)
    wt = torch.tensor(w, requires_grad=True)
    vt = torch.tensor(v, requires_grad=True)
    spk, v_fin = t_macro.fused_seq_vjp(
        torch.tensor(x), wt, torch.tensor(scale), mcfg, vt, k=12,
        drive_gain=0.25, use_snl=noisy, snl_amp=0.05 if noisy else 0.0,
        kwn_relax=0.1, surrogate_beta=sbeta, seed=7)
    loss = (spk * torch.tensor(g_spk)).sum() \
        + (v_fin * torch.tensor(g_vfin)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, (wt, vt))]


@pytest.mark.parametrize("noisy", [False, True], ids=["snl_off", "noisy"])
def test_fused_seq_vjp_takes_surrogate_beta(noisy):
    """The gradients at ``surrogate_beta=2.0`` against ``jax.grad`` of the
    reference's pure-jnp oracle at 2.0, within ``rtol=1e-5, atol=1e-6``
    (the two sum ``dW`` in other orders); 4.0 gives others."""
    x, w, scale, v, g_spk, g_vfin = _vjp_case(noisy)
    jcb = j_ima.nlq_codebook(5, -24.0, 24.0, 2.0)
    kn = j_ima.kernel_noise_params(j_ima.IMANoiseModel(), jcb) \
        if noisy else None

    def loss(w_, v_):
        v_fin, spk = j_ref.fused_macro_seq_vjp_ref(
            w_, jnp.asarray(x), jcb.boundaries, jcb.levels,
            jnp.asarray(scale), v_, None, k=12, drive_gain=0.25,
            use_snl=noisy, ima_noise=kn, snl_amp=0.05 if noisy else 0.0,
            seed=7, kwn_relax=0.1, surrogate_beta=2.0, ste_lo=-24.5,
            ste_hi=24.5)[:2]
        return jnp.sum(spk * g_spk) + jnp.sum(v_fin * g_vfin)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(v))
    got = _port_vjp_grads(noisy, 2.0)
    for name, a, b in zip(("dW", "dv0"), got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    assert np.abs(got[0]).max() > 0
    assert not np.array_equal(got[0], _port_vjp_grads(noisy, 4.0)[0])


# --- the sequence oracles in the reference's convention --------------------

T_SEQ, K_IN, N_OUT, J_BR = 6, 64, 16, 2


def _seq_operands(mode, lead, seed=0):
    """numpy operands of one sequence: x (T, *lead, K) int8, planes
    (K, NC) int8, codebook, scale (NC,), v (*lead, N), a pre-drawn SNL
    noise (T, *lead, N) and w_dend (J, N) (NLD)."""
    rs = np.random.RandomState(seed)
    nc = N_OUT * (J_BR if mode == "nld" else 1)
    x = rs.choice([-1, 0, 1], p=[0.1, 0.8, 0.1],
                  size=(T_SEQ, *lead, K_IN)).astype(np.int8)
    msb, lsb = (rs.randint(-1, 2, (K_IN, nc)).astype(np.int8)
                for _ in range(2))
    scale = rs.uniform(0.05, 0.3, nc).astype(np.float32)
    v = (rs.randn(*lead, N_OUT) * 0.5).astype(np.float32)
    noise = (rs.choice([-1.0, 1.0], size=(T_SEQ, *lead, N_OUT))
             * 0.05).astype(np.float32)
    w_dend = rs.randn(J_BR, N_OUT).astype(np.float32)
    return x, msb, lsb, scale, v, noise, w_dend


def _codebooks(mode):
    if mode == "kwn":
        return (j_ima.nlq_codebook(5, -24.0, 24.0),
                t_ima.nlq_codebook(5, -24.0, 24.0))
    return (j_ima.activation_codebook(5, j_ima.relu, -4.0, 4.0),
            t_ima.activation_codebook(5, t_ima.relu, -4.0, 4.0))


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _equal_all(got, want):
    """Every output (and every entry of a per-layer list) of the same
    shape, dtype and bits."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if isinstance(b, (list, tuple)):
            _equal_all(a, b)
            continue
        a, b = a.numpy(), np.asarray(b)
        assert (a.shape, a.dtype) == (b.shape, b.dtype), (i, a.shape,
                                                          b.shape)
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=str(i))


SEQ_CASES = {
    # (mode, leading dims, noise kind)
    "kwn-clean": ("kwn", (12,), "none"),
    "kwn-noisy": ("kwn", (12,), "counter"),
    "kwn-prbs-2lead": ("kwn", (3, 4), "drawn"),
    "kwn-clean-2lead": ("kwn", (2, 5), "none"),
    "nld-clean": ("nld", (12,), "none"),
    "nld-noisy": ("nld", (12,), "counter"),
    "nld-clean-2lead": ("nld", (3, 4), "none"),
}


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_fused_macro_seq_ref_called_as_the_reference_bench_calls_it(case):
    """``jax.jit(functools.partial(ref.fused_macro_seq_ref, ...))(x, msb,
    lsb, boundaries, levels, scale, v, None[, w_dend])`` as the
    reference's fused-macro benchmark calls it, at ``step_offset=3``:
    every output bit for bit."""
    mode, lead, kind = SEQ_CASES[case]
    x, msb, lsb, scale, v, noise, w_dend = _seq_operands(mode, lead)
    jcb, tcb = _codebooks(mode)
    kw = dict(mode=mode, k=4, drive_gain=0.25, step_offset=3)
    jkw, tkw = dict(kw), dict(kw)
    if kind == "counter":
        jkw.update(ima_noise=j_ima.kernel_noise_params(
            j_ima.IMANoiseModel(), jcb), snl_amp=0.05, seed=7)
        tkw.update(ima_noise=t_ima.kernel_noise_params(
            t_ima.IMANoiseModel(), tcb), snl_amp=0.05, seed=7)
    nz = noise if kind == "drawn" else None
    jargs = (jnp.asarray(x), jnp.asarray(msb), jnp.asarray(lsb),
             jcb.boundaries, jcb.levels, jnp.asarray(scale), jnp.asarray(v),
             None if nz is None else jnp.asarray(nz))
    targs = (torch.from_numpy(x), torch.from_numpy(msb),
             torch.from_numpy(lsb), tcb.boundaries, tcb.levels,
             torch.from_numpy(scale), torch.from_numpy(v),
             None if nz is None else torch.from_numpy(nz))
    if mode == "nld":
        jargs += (jnp.asarray(w_dend),)
        targs += (torch.from_numpy(w_dend),)
    want = jax.jit(functools.partial(j_ref.fused_macro_seq_ref, **jkw))(
        *jargs)
    got = t_ref.fused_macro_seq_ref(*targs, **tkw)
    _equal_all(got, want)
    assert got[4].shape == (T_SEQ, *lead, 1)
    assert float(got[2].sum()) > 0


def test_fused_macro_seq_ref_counter_streams_need_rows():
    x, msb, lsb, scale, v, _, _ = _seq_operands("kwn", (3, 4))
    _, tcb = _codebooks("kwn")
    with pytest.raises(ValueError, match="counter"):
        t_ref.fused_macro_seq_ref(
            torch.from_numpy(x), torch.from_numpy(msb), torch.from_numpy(lsb),
            tcb.boundaries, tcb.levels, torch.from_numpy(scale),
            torch.from_numpy(v), snl_amp=0.05)


def _stack_operands(lead, widths=(24, 16), seed=5):
    rs = np.random.RandomState(seed)
    x = rs.choice([-1, 0, 1], p=[0.1, 0.8, 0.1],
                  size=(T_SEQ, *lead, K_IN)).astype(np.int8)
    jcb, tcb = _codebooks("kwn")
    jstack, tstack, f_in = [], [], K_IN
    for w in widths:
        msb, lsb = (rs.randint(-1, 2, (f_in, w)).astype(np.int8)
                    for _ in range(2))
        scale = rs.uniform(0.05, 0.3, w).astype(np.float32)
        jstack.append((jnp.asarray(msb), jnp.asarray(lsb), jcb.boundaries,
                       jcb.levels, jnp.asarray(scale)))
        tstack.append((torch.from_numpy(msb), torch.from_numpy(lsb),
                       tcb.boundaries, tcb.levels, torch.from_numpy(scale)))
        f_in = w
    vs = [(rs.randn(*lead, w) * 0.5).astype(np.float32) for w in widths]
    noises = [(rs.choice([-1.0, 1.0], size=(T_SEQ, *lead, w)) * 0.05)
              .astype(np.float32) for w in widths]
    return x, jstack, tstack, vs, noises, jcb, tcb


@pytest.mark.parametrize("lead,noisy", [((12,), False), ((3, 4), False),
                                        ((12,), True)],
                         ids=["drawn", "drawn-2lead", "counter"])
def test_fused_macro_multi_seq_ref_called_as_the_reference_bench_calls_it(
        lead, noisy):
    """``ref.fused_macro_multi_seq_ref(x, planes, vs, noises, ks=...,
    drive_gain=...)`` as the reference's benchmark calls it (eager), and
    with the counter streams at per-layer seeds and ``step_offset=2``:
    every output bit for bit, the per-layer lists included."""
    x, jstack, tstack, vs, noises, jcb, tcb = _stack_operands(lead)
    kw = dict(ks=(4, 3), drive_gain=0.25)
    jkw, tkw = dict(kw), dict(kw)
    if noisy:
        noises = None
        for d, ima, cb in ((jkw, j_ima, jcb), (tkw, t_ima, tcb)):
            d.update(ima_noise=ima.kernel_noise_params(ima.IMANoiseModel(),
                                                       cb),
                     snl_amp=0.05, seeds=(3, 11), step_offset=2)
    want = j_ref.fused_macro_multi_seq_ref(
        jnp.asarray(x), jstack, [jnp.asarray(a) for a in vs],
        None if noises is None else [jnp.asarray(a) for a in noises], **jkw)
    got = t_ref.fused_macro_multi_seq_ref(
        torch.from_numpy(x), tstack, [torch.from_numpy(a) for a in vs],
        None if noises is None else [torch.from_numpy(a) for a in noises],
        **tkw)
    _equal_all(got, want)
    assert float(got[1].sum()) > 0


# --- the kernel-level entry in NLD mode ------------------------------------

@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
def test_kernel_fused_macro_seq_nld_mode_is_its_plain_version(noisy):
    """``kernels.fused_macro.fused_macro_seq(..., w_dend, mode="nld")`` on
    CPU tensors (padded: M a multiple of ``bm``, K of ``bk``): the plain
    version of #2, equal bit for bit to the reference's jitted oracle and
    to ``fused_macro_seq_nld``, no launch counted."""
    x, msb, lsb, scale, v, _, w_dend = _seq_operands("nld", (8,), seed=2)
    jcb, tcb = _codebooks("nld")
    tkn = t_ima.kernel_noise_params(t_ima.IMANoiseModel(), tcb) \
        if noisy else None
    jkn = j_ima.kernel_noise_params(j_ima.IMANoiseModel(), jcb) \
        if noisy else None
    args = (torch.from_numpy(x), torch.from_numpy(msb),
            torch.from_numpy(lsb), tcb.boundaries, tcb.levels,
            torch.from_numpy(scale), torch.from_numpy(v))
    counters = (t_fused.fused_macro_seq.launches,
                t_fused.fused_macro_seq_nld.launches)
    got = t_fused.fused_macro_seq(
        *args, None, torch.from_numpy(w_dend), mode="nld", drive_gain=0.25,
        bm=8, bk=64, ima_noise=tkn, seed=5, step_offset=3)
    want = jax.jit(functools.partial(
        j_ref.fused_macro_seq_ref, mode="nld", drive_gain=0.25,
        ima_noise=jkn, seed=5, step_offset=3))(
        jnp.asarray(x), jnp.asarray(msb), jnp.asarray(lsb), jcb.boundaries,
        jcb.levels, jnp.asarray(scale), jnp.asarray(v), None,
        jnp.asarray(w_dend))
    _equal_all(got, want)
    direct = t_fused.fused_macro_seq_nld(
        args[0], *args[1:6], torch.from_numpy(w_dend), args[6],
        drive_gain=0.25, bm=8, bk=64, ima_noise=tkn, seed=5, step_offset=3)
    for a, b in zip(got, direct):
        assert torch.equal(a, b)
    assert (t_fused.fused_macro_seq.launches,
            t_fused.fused_macro_seq_nld.launches) == counters
    with pytest.raises(ValueError, match="KWN-only"):
        t_fused.fused_macro_seq(*args, None, torch.from_numpy(w_dend),
                                mode="nld", bm=8, bk=64, train_trace=True)
    with pytest.raises(ValueError, match="w_dend"):
        t_fused.fused_macro_seq(*args, mode="nld", bm=8, bk=64)
    with pytest.raises(ValueError, match="unknown mode"):
        t_fused.fused_macro_seq(*args, mode="lif", bm=8, bk=64)


# --- the engine's per-step cadence -----------------------------------------

ENGINE_KW = dict(n_in=32, n_hidden=16, n_classes=3, n_steps=8, k=4)


def _engine_params(kind):
    if kind == "stack":
        tcfg = t_snn.SNNConfig(**dict(ENGINE_KW, hidden_layers=(24, 16)))
        return None, tcfg, t_snn.init_params(
            tcfg, torch.Generator().manual_seed(0), "cpu")
    kw = dict(ENGINE_KW, mode=kind)
    jcfg = j_snn.SNNConfig(**kw)
    p = {k: v for k, v in
         j_snn.init_params(jcfg, jax.random.PRNGKey(0)).items()}
    return (jcfg, p), t_snn.SNNConfig(**kw), convert.snn_params_from_jax(
        p, "cpu")


def _requests(n=7, seed=3):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        t = (5, 9)[i % 2]
        rate = (0.05, 0.2, 0.4)[i % 3]
        out.append(rs.choice([-1.0, 0.0, 1.0],
                             p=[rate / 2, 1 - rate, rate / 2],
                             size=(t, ENGINE_KW["n_in"])).astype(np.float32))
    return out


def _serve(tcfg, tp, events, noise, time_major):
    eng = t_engine.SNNEventEngine(tcfg, tp, batch_slots=3, seed=5,
                                  time_major=time_major, continuous=False,
                                  noise=noise, device="cpu")
    for i, ev in enumerate(events):
        eng.submit(t_engine.EventRequest(uid=i, events=ev))
    eng.run()
    return sorted(eng.completed, key=lambda r: r.uid)


@pytest.mark.parametrize("kind,noisy", [("kwn", False), ("kwn", True),
                                        ("nld", False), ("nld", True),
                                        ("stack", False)])
def test_per_step_engine_equals_time_major_engine(kind, noisy, monkeypatch):
    """``SNNEventEngine(time_major=False, continuous=False)`` serves each
    batch through ``forward_silicon(fused="step")`` and every request's
    logits and telemetry equal those of the time-major drain path bit for
    bit; a stack takes the stacked kernel either way."""
    _, tcfg, tp = _engine_params(kind)
    noise = t_ima.IMANoiseModel() if noisy else None
    events = _requests()
    cadences = []
    real = t_snn.forward_silicon

    def spy(*args, **kwargs):
        cadences.append(kwargs["fused"])
        return real(*args, **kwargs)

    monkeypatch.setattr(t_snn, "forward_silicon", spy)
    step = _serve(tcfg, tp, events, noise, False)
    assert cadences and set(cadences) == {"step"}
    cadences.clear()
    seq = _serve(tcfg, tp, events, noise, True)
    assert set(cadences) == {"seq"}
    assert len(step) == len(seq) == len(events)
    for a, b in zip(step, seq):
        assert torch.equal(a.logits, b.logits), a.uid
        assert (a.pred, a.adc_steps, a.sops, a.skipped_block_ratio) == \
            (b.pred, b.adc_steps, b.sops, b.skipped_block_ratio), a.uid


def test_per_step_engine_rejects_continuous_as_the_reference():
    """``time_major=False`` with ``continuous=True`` raises ``ValueError``
    in both packages; ``continuous=None`` falls back to the drain path."""
    (jcfg, jp), tcfg, tp = _engine_params("kwn")
    with pytest.raises(ValueError, match="time-major"):
        t_engine.SNNEventEngine(tcfg, tp, time_major=False, continuous=True,
                                device="cpu")
    with pytest.raises(ValueError, match="time-major"):
        j_engine.SNNEventEngine(jcfg, jp, time_major=False, continuous=True)
    eng = t_engine.SNNEventEngine(tcfg, tp, time_major=False, device="cpu")
    ref_eng = j_engine.SNNEventEngine(jcfg, jp, time_major=False)
    assert eng.continuous is False and ref_eng.continuous is False
    assert eng.time_major is False and eng._state is None
    assert t_engine.SNNEventEngine(tcfg, tp, device="cpu").continuous
    _, scfg, sp = _engine_params("stack")
    with pytest.raises(ValueError, match="single-layer"):
        t_engine.SNNEventEngine(scfg, sp, continuous=True, device="cpu")
    assert not t_engine.SNNEventEngine(scfg, sp, time_major=False,
                                       device="cpu").continuous
