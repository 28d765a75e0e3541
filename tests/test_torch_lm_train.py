"""LM training in the port against the JAX package on the CPU:
``lm.loss_fn`` and its gradients for every reduced config, remat, the
loss mask, the eval step, and the microbatched train step over three
steps (the optimizer's parts: ``test_torch_optim.py``).

The JAX parameters come from ``repro.nn.module.materialize`` and cross
over as numpy arrays (``convert.lm_params_from_jax``); tokens come from
``numpy.random.RandomState``, or from the reference's ``SyntheticLM``
where the reference's own batches are the point.  The reference's
gradients are its jitted ``value_and_grad``.  Every reduced config runs
in f32.  Tolerances: the loss within 1e-5 relative; each gradient leaf
within 1e-4 of the leaf's largest magnitude (the two sides round the
same f32 sums in another order, ~1e-6 seen), except xlstm's, whose
normalisers cancel so that the reference's own gradients move by ~7e-5
of a leaf when the embedding table moves by one ULP: its leaves are held
to four times that change (``_leaf_tol``), the rule its forward follows
in ``test_torch_lm_families.py``.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.configs import base as j_base
from repro.data import synthetic_lm as j_data
from repro.models import lm as j_lm
from repro.nn import module as j_module
from repro.train import optim as j_optim
from repro.train import train_loop as j_loop
from repro_torch import configs as t_configs
from repro_torch.configs import base as t_base
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import lm as t_lm
from repro_torch.nn import module as t_module
from repro_torch.train import optim as t_optim
from repro_torch.train import train_loop as t_loop

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4
SEQ = 64
# the ten registry configs reduced, then smollm in CIM mode and qwen2.5
# with KWN-FFN sparsity: the two paper paths that train through STEs
CASES = [(arch, {}) for arch in sorted(j_configs.ARCHS)] + [
    ("smollm-135m", {"cim_linear": True}),
    ("qwen2.5-32b", {"kwn_ffn_k": 16})]


def _case_id(case):
    arch, kw = case
    return arch + "".join(f"-{k}" for k in kw)


def _cfgs(arch, **kw):
    return (dataclasses.replace(j_base.reduced(j_configs.ARCHS[arch]), **kw),
            dataclasses.replace(t_base.reduced(t_configs.ARCHS[arch]), **kw))


def _params(jc, seed=0):
    jp = jax.tree.map(np.asarray, j_module.materialize(
        j_lm.param_specs(jc), jax.random.PRNGKey(seed)))
    return jp, lm_params_from_jax(jp, device="cpu")


def _batch(cfg, rs, b=2, s=SEQ) -> dict:
    """Numpy inputs of ``s`` positions: audio frames with class targets
    and a loss mask (hubert); else tokens, after the patch embeddings
    for the VLM (its text shortened so that the sequence stays ``s``,
    a multiple of the attention chunk)."""
    if cfg.frontend == "audio_frames":
        return {"frames": rs.randn(b, s, cfg.frontend_dim).astype(np.float32),
                "targets": rs.randint(0, cfg.vocab_size, (b, s)
                                      ).astype(np.int32),
                "loss_mask": rs.rand(b, s) < 0.5}
    out = {"tokens": rs.randint(0, cfg.vocab_size,
                                (b, s - cfg.n_patches)).astype(np.int32)}
    if cfg.frontend == "vision_patches":
        out["patches"] = rs.randn(b, cfg.n_patches,
                                  cfg.frontend_dim).astype(np.float32)
    return out


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jax_loss_and_grads(jc, jp, batch, _compiled={}):
    """The reference's jitted ``value_and_grad`` of ``loss_fn`` (one
    compile per config: ``LMConfig`` does not hash, so keyed on its
    repr)."""
    fn = _compiled.setdefault(repr(jc), jax.jit(jax.value_and_grad(
        functools.partial(j_lm.loss_fn, cfg=jc), has_aux=True)))
    (loss, parts), grads = fn(jp, batch)
    return float(loss), parts, grads


def _port_loss_and_grads(tc, tp, batch):
    live = t_module.tree_map(lambda p: p.detach().requires_grad_(), tp)
    loss, parts = t_lm.loss_fn(live, _torch_batch(batch), tc)
    flat = t_module.leaves(live)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            t_module.unflatten(tp, grads))


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def _leaf_errors(jgrads, tgrads) -> dict:
    """Each leaf's largest difference over the leaf's largest magnitude."""
    out = {}
    for path, want in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        want = np.asarray(want)
        got = _leaf(tgrads, path).numpy()
        assert got.shape == want.shape, jax.tree_util.keystr(path)
        out[jax.tree_util.keystr(path)] = float(
            np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    return out


def _leaf_tol(jc, jp, batch, jgrads) -> float:
    """LEAF_TOL, or for a configuration with mLSTM blocks four times the
    reference's own largest leaf change when its embedding table moves
    by one ULP (the seed of ``test_torch_lm_families._tol``)."""
    if "mlstm" not in jc.pattern:
        return LEAF_TOL
    rs = np.random.RandomState(99)
    table = jp["embed"]["table"]
    moved = dict(jp, embed={"table": np.nextafter(table, np.where(
        rs.rand(*table.shape) < 0.5, np.inf, -np.inf).astype(np.float32))})
    _, _, g_moved = _jax_loss_and_grads(jc, moved, batch)
    moved_tree = jax.tree.map(lambda x: torch.from_numpy(np.array(x)),
                              g_moved)
    noise = max(_leaf_errors(jgrads, moved_tree).values())
    return max(LEAF_TOL, 4 * noise)


# --- loss_fn and its gradients ----------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_loss_and_grads_match_reference(case):
    arch, kw = case
    jc, tc = _cfgs(arch, **kw)
    jp, tp = _params(jc)
    batch = _batch(jc, np.random.RandomState(1))
    jloss, jparts, jgrads = _jax_loss_and_grads(jc, jp, batch)
    tloss, tparts, tgrads = _port_loss_and_grads(tc, tp, batch)
    assert abs(float(tloss) - jloss) <= LOSS_RTOL * abs(jloss)
    np.testing.assert_allclose(float(tparts["aux"]),
                               float(jparts["aux"]), rtol=1e-5, atol=1e-7)
    if jc.moe:
        assert float(tparts["aux"]) > 0.0
    errs = _leaf_errors(jgrads, tgrads)
    tol = _leaf_tol(jc, jp, batch, jgrads)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, (worst, errs[worst], tol)
    assert len(errs) == len(t_module.leaves(tp))


@pytest.mark.parametrize("mode", ["group", "attn_only"])
def test_remat_changes_no_value(mode):
    """Recompute in the backward gives the bits of keeping everything:
    the loss and every gradient (which the test above holds to the
    reference)."""
    jc, tc = _cfgs("gemma2-2b")
    _, tp = _params(jc)
    batch = _batch(jc, np.random.RandomState(2))
    base = _port_loss_and_grads(tc, tp, batch)
    rc = dataclasses.replace(tc, remat=True, remat_mode=mode)
    got = _port_loss_and_grads(rc, tp, batch)
    assert torch.equal(got[0], base[0])
    for a, b in zip(t_module.leaves(got[2]), t_module.leaves(base[2])):
        assert torch.equal(a, b)


def test_loss_mask_and_padded_vocab():
    """A decoder's ``loss_mask`` keeps only its positions (the mean over
    them, the first position never a target), and the cross-entropy
    normalises over the padded vocabulary, as the reference does."""
    jc, tc = _cfgs("qwen2.5-32b", vocab_size=100)
    assert tc.padded_vocab == 112
    jp, tp = _params(jc)
    rs = np.random.RandomState(3)
    batch = _batch(jc, rs)
    batch["loss_mask"] = rs.rand(*batch["tokens"].shape) < 0.3
    jloss, _, jgrads = _jax_loss_and_grads(jc, jp, batch)
    tloss, _, tgrads = _port_loss_and_grads(tc, tp, batch)
    assert abs(float(tloss) - jloss) <= LOSS_RTOL * abs(jloss)
    assert max(_leaf_errors(jgrads, tgrads).values()) <= LEAF_TOL
    unmasked = _port_loss_and_grads(tc, tp, {"tokens": batch["tokens"]})[0]
    assert float(unmasked) != float(tloss)


def test_eval_step_equals_loss_fn_and_reference():
    """``build_eval_step`` runs under ``no_grad`` (the flash kernel's
    plain version on the CPU) and equals ``loss_fn`` under autograd (the
    blockwise attention) and the reference's eval step."""
    jc, tc = _cfgs("smollm-135m")
    jp, tp = _params(jc)
    batch = _batch(jc, np.random.RandomState(4))
    got = t_loop.build_eval_step(tc)(tp, _torch_batch(batch))
    assert not got["loss"].requires_grad
    under_grad = _port_loss_and_grads(tc, tp, batch)[0]
    want = j_loop.build_eval_step(jc)(jp, batch)
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    np.testing.assert_allclose(float(got["loss"]), float(under_grad),
                               rtol=LOSS_RTOL)


def test_features_then_head_equal_forward():
    """``features`` is the forward up to the unembedding."""
    _, tc = _cfgs("gemma2-2b")
    _, tp = _params(_cfgs("gemma2-2b")[0])
    toks = torch.from_numpy(np.random.RandomState(5).randint(
        0, tc.vocab_size, (2, SEQ)))
    with torch.no_grad():
        x, aux = t_lm.features(tp, {"tokens": toks}, tc)
        logits = t_lm.layers.softcap(t_lm.layers.unembed(
            tp["embed"], x).float(), tc.final_softcap)
    want, want_aux = t_lm.forward(tp, {"tokens": toks}, tc)
    torch.testing.assert_close(logits, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(aux, want_aux)


# --- helpers of the AdamW checks -------------------------------------------

def _ocfg(**kw):
    base = dict(lr=3e-3, warmup_steps=5, total_steps=20)
    base.update(kw)
    return j_optim.AdamWConfig(**base), t_optim.AdamWConfig(**base)


def _params_close(got, want, lr_sum):
    """Parameters after AdamW updates.  Adam divides each element's
    moment by its root second moment, so an element whose gradient is
    near zero moves by a share of lr that follows the gradient's last
    bits: one element in 10^4-10^5 ends 2e-6 to 2.1e-5 apart after three
    steps (lr at most 3e-3).  So: all but one element in a thousand
    within 1e-6, all but one in 10^4 within 1e-5, and every one within
    ``lr_sum``, half the most two AdamW runs can part an element."""
    diffs = np.concatenate([
        np.abs(_leaf(got, path).float().numpy() - np.asarray(w)).ravel()
        for path, w in jax.tree_util.tree_flatten_with_path(want)[0]])
    assert np.mean(diffs > 1e-6) <= 1e-3
    assert np.mean(diffs > 1e-5) <= 1e-4
    assert diffs.max() <= lr_sum


def _tree_close(got, want, **tol):
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = _leaf(got, path)
        w = np.asarray(w)
        assert g.dtype == {"float32": torch.float32, "bfloat16":
                           torch.bfloat16}[w.dtype.name], path
        np.testing.assert_allclose(g.float().numpy(), w.astype(np.float32),
                                   **tol, err_msg=jax.tree_util.keystr(path))


# --- the train step -------------------------------------------------------

def _reference_batches(jc, n_steps, n_micro, global_batch=4, seq=32):
    """The reference's ``SyntheticLM`` batches, split for the step."""
    data = j_data.SyntheticLM(j_data.DataConfig(
        vocab_size=jc.vocab_size, seq_len=seq, global_batch=global_batch,
        seed=3))
    return [jax.tree.map(np.asarray, data.batch_at(s, n_micro=n_micro))
            for s in range(n_steps)]


@pytest.mark.parametrize("arch", ["smollm-135m", "kimi-k2-1t-a32b"])
def test_train_step_matches_reference_over_three_steps(arch):
    """``build_train_step`` with two microbatches, three steps on the
    reference's batches from the same parameters: loss, grad norm and lr
    every step, then parameters and moments.  The port's ``microbatch``
    splits as the reference's data pipeline does."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc)
    jo, to = _ocfg()
    jstate, tstate = j_optim.adamw_init(jp, jo), t_optim.adamw_init(tp, to)
    jstep = jax.jit(j_loop.build_train_step(jc, None, n_micro=2, opt_cfg=jo))
    tstep = t_loop.build_train_step(tc, n_micro=2, opt_cfg=to)
    lr_sum = 0.0
    for batch in _reference_batches(jc, 3, 2):
        whole = np.array(batch["tokens"]).reshape(
            -1, batch["tokens"].shape[-1])
        split = t_loop.microbatch({"tokens": torch.from_numpy(whole)}, 2)
        assert np.array_equal(split["tokens"].numpy(), batch["tokens"])
        jp, jstate, jm = jstep(jp, jstate, batch)
        tp, tstate, tm = tstep(tp, tstate, split)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
        lr_sum += float(tm["lr"])
    _params_close(tp, jp, lr_sum)
    _tree_close(tstate.mu, jstate.mu, rtol=1e-4, atol=1e-7)
    _tree_close(tstate.nu, jstate.nu, rtol=1e-4, atol=1e-10)


def test_microbatch_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="does not split"):
        t_loop.microbatch({"tokens": torch.zeros((5, 4))}, 2)
