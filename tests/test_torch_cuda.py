"""Tests of the port that need the card (marker ``cuda``).

They import neither JAX nor ``repro`` (the GPU machine has no JAX), and
they skip with a reason where no CUDA device is present.  On the GPU
(``--noconftest``: ``tests/conftest.py`` imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import dendrite as dendrite_lib
from repro_torch.core import ima as ima_lib
from repro_torch.core import macro as macro_lib
from repro_torch.kernels import fused_macro, fused_macro_grad, ops, ref
from repro_torch.models import snn

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _weights(rs, kdim, n):
    w_int = torch.from_numpy(rs.randint(-3, 4, size=(kdim, n))).float()
    scale = torch.from_numpy(rs.uniform(0.01, 0.1, n).astype(np.float32))
    cfg = macro_lib.CIMMacroConfig(code_bits=5, mac_range=24.0,
                                   ima_noise=ima_lib.IMANoiseModel())
    return macro_lib.pack_kwn_weights(w_int, scale, cfg), cfg


@pytest.mark.parametrize("shape", [(8, 64, 512, 128), (6, 37, 300, 200)],
                         ids=str)
@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
def test_kernel_matches_plain_version(cuda, shape, noisy):
    t, m, kdim, n = shape
    rs = np.random.RandomState(0)
    fw, cfg = _weights(rs, kdim, n)
    x = torch.from_numpy(rs.choice([-1.0, 0.0, 1.0], p=[0.05, 0.9, 0.05],
                                   size=(t, m, kdim)).astype(np.float32))
    v0 = torch.from_numpy(rs.uniform(-1, 1.2, (m, n)).astype(np.float32))
    nz = None if noisy else torch.from_numpy(
        rs.choice([-0.05, 0.05], size=(t, m, n)).astype(np.float32))
    kw = dict(k=12, drive_gain=0.25, seed=7, step_offset=2)
    if noisy:
        kw.update(ima_noise=macro_lib.fused_kernel_noise(fw, cfg),
                  snl_amp=0.05)
    before = fused_macro.fused_macro_seq.launches
    got = ops.fused_macro_seq(x, *fw[:2], fw.boundaries, fw.levels,
                              fw.scale, v0, nz, device=cuda, **kw)
    torch.cuda.synchronize()
    assert fused_macro.fused_macro_seq.launches == before + 1
    want = ops.fused_macro_seq(x, *fw[:2], fw.boundaries, fw.levels,
                               fw.scale, v0, nz, device="cpu", **kw)
    for name, a, b in zip(("mac", "v_out", "spikes", "mask", "steps"),
                          got, want):
        assert torch.equal(a.cpu(), b), name


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
def test_forward_on_card_equals_cpu(cuda, noisy):
    cfg = snn.SNNConfig(n_in=96, n_hidden=40, n_classes=5, k=6)
    p = snn.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rs = np.random.RandomState(5)
    ev = rs.choice([-1.0, 0.0, 1.0], p=[0.1, 0.8, 0.1],
                   size=(4, 11, cfg.n_in)).astype(np.float32)
    noise = ima_lib.IMANoiseModel() if noisy else None
    (lg, tg), (lc, tc) = (
        snn.forward_silicon(p, ev, cfg, seed=99, noise=noise, device=dev)
        for dev in (cuda, "cpu"))
    for key in ("adc_steps", "sops", "skipped_block_ratio"):
        assert torch.equal(tg[key].cpu(), tc[key]), key
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-5,
                               atol=1e-6)


def _nld_weights(kdim, n, n_branches, activation, seed=0):
    dp = dendrite_lib.dendrite_init(torch.Generator().manual_seed(seed),
                                    kdim, n, n_branches, device="cpu")
    cfg = macro_lib.CIMMacroConfig(code_bits=5, mac_range=4.0,
                                   ima_noise=ima_lib.IMANoiseModel())
    return macro_lib.pack_nld_weights(dp, cfg, activation), cfg


@pytest.mark.parametrize("shape", [(8, 64, 512, 128, 2, "relu"),
                                   (6, 37, 300, 40, 3, "sigmoid4"),
                                   (5, 13, 96, 50, 3, "quadratic")],
                         ids=str)
@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
def test_nld_kernel_matches_plain_version(cuda, shape, noisy):
    t, m, kdim, n, n_branches, activation = shape
    rs = np.random.RandomState(1)
    fw, cfg = _nld_weights(kdim, n, n_branches, activation)
    x = torch.from_numpy(rs.choice([-1.0, 0.0, 1.0], p=[0.05, 0.9, 0.05],
                                   size=(t, m, kdim)).astype(np.float32))
    v0 = torch.from_numpy(rs.uniform(-1, 1.2, (m, n)).astype(np.float32))
    kw = dict(mode="nld", drive_gain=0.25, seed=7, step_offset=2)
    if noisy:
        kw.update(ima_noise=macro_lib.fused_kernel_noise(fw, cfg))
    before = fused_macro.fused_macro_seq_nld.launches
    got = ops.fused_macro_seq(x, fw.msb, fw.lsb, fw.boundaries, fw.levels,
                              fw.scale, v0, None, fw.w_dend, device=cuda,
                              **kw)
    torch.cuda.synchronize()
    assert fused_macro.fused_macro_seq_nld.launches == before + 1
    want = ops.fused_macro_seq(x, fw.msb, fw.lsb, fw.boundaries, fw.levels,
                               fw.scale, v0, None, fw.w_dend, device="cpu",
                               **kw)
    for name, a, b in zip(("mac", "v_out", "spikes", "mask", "steps"),
                          got, want):
        assert torch.equal(a.cpu(), b), name
    assert want[2].sum() > 0


def _stack(rs, kdim, widths):
    cfg = macro_lib.CIMMacroConfig(code_bits=5, mac_range=24.0,
                                   ima_noise=ima_lib.IMANoiseModel())
    fan_ins = (kdim,) + tuple(widths[:-1])
    stack = macro_lib.pack_kwn_stack(
        [torch.from_numpy(rs.randint(-3, 4, (a, b))).float()
         for a, b in zip(fan_ins, widths)],
        [torch.from_numpy(rs.uniform(0.01, 0.1, b).astype(np.float32))
         for b in widths], cfg)
    return stack, cfg


@pytest.mark.parametrize("shape", [(30, 64, 512, (128, 128), (12, 12)),
                                   (6, 37, 300, (300, 20), (12, 3)),
                                   (5, 13, 96, (40, 200, 20), (4, 12, 3))],
                         ids=str)
@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
def test_stack_kernel_matches_plain_version(cuda, shape, noisy):
    t, m, kdim, widths, ks = shape
    rs = np.random.RandomState(2)
    stack, cfg = _stack(rs, kdim, widths)
    x = torch.from_numpy(rs.choice([-1.0, 0.0, 1.0], p=[0.05, 0.9, 0.05],
                                   size=(t, m, kdim)).astype(np.float32))
    vs = [torch.from_numpy(rs.uniform(-1, 1.2, (m, w)).astype(np.float32))
          for w in widths]
    nz = None if noisy else [torch.from_numpy(rs.choice(
        [-0.05, 0.05], size=(t, m, w)).astype(np.float32)) for w in widths]
    kw = dict(ks=ks, drive_gain=0.25)
    if noisy:
        kw.update(ima_noise=macro_lib.fused_kernel_noise(stack[0], cfg),
                  snl_amp=0.05, seeds=[5, 6, 7][:len(widths)],
                  step_offset=4)
    before = fused_macro.fused_macro_multi_seq.launches
    got = macro_lib.fused_multi_seq(x.to(cuda), stack, vs, nz, **kw)
    torch.cuda.synchronize()
    assert fused_macro.fused_macro_multi_seq.launches == before + 1
    want = macro_lib.fused_multi_seq(x, stack, vs, nz, **kw)
    for name in ("v_outs", "steps", "spike_counts", "occupancy"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            assert torch.equal(a.cpu(), b), name
    assert torch.equal(got.spikes.cpu(), want.spikes)
    assert torch.equal(got.mask.cpu(), want.mask)
    assert got.total_blocks == want.total_blocks
    assert want.spikes.sum() > 0


def test_stack_too_wide_for_registers_raises(cuda):
    rs = np.random.RandomState(3)
    stack, _ = _stack(rs, 64, (512, 512, 512))
    x = torch.zeros((2, 4, 64), device=cuda)
    vs = [torch.zeros((4, 512)) for _ in range(3)]
    with pytest.raises(ValueError, match="register columns"):
        macro_lib.fused_multi_seq(x, stack, vs, None, ks=(4, 4, 4))


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
@pytest.mark.parametrize("kind", ["nld", "stack"])
def test_nld_and_stack_forward_on_card_equals_cpu(cuda, kind, noisy):
    if kind == "nld":
        cfg = snn.SNNConfig(n_in=96, n_hidden=40, n_classes=5, mode="nld",
                            n_branches=3, activation="relu")
    else:
        cfg = snn.SNNConfig(n_in=96, n_classes=5, hidden_layers=(64, 48),
                            k_layers=(6, 5))
    p = snn.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rs = np.random.RandomState(5)
    ev = rs.choice([-1.0, 0.0, 1.0], p=[0.1, 0.8, 0.1],
                   size=(4, 11, cfg.n_in)).astype(np.float32)
    noise = ima_lib.IMANoiseModel() if noisy else None
    (lg, tg), (lc, tc) = (
        snn.forward_silicon(p, ev, cfg, seed=99, noise=noise, device=dev)
        for dev in (cuda, "cpu"))
    for key in ("adc_steps", "lif_updates", "sops", "skipped_block_ratio"):
        assert torch.equal(tg[key].cpu(), tc[key]), key
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-5,
                               atol=1e-6)


# --- silicon training: the forward's trace and the backward kernel ---------

def _ulps(a, b):
    return int((a.view(torch.int32).long() - b.view(torch.int32).long())
               .abs().max())


def _train_operands(shape, noisy, dev, seed=0):
    """A training forward on the card (``train_trace``, MAC residual) and
    random cotangents: (x, w, scale, mask, vtrace, mac, g_spk, g_vfin) on
    ``dev``, and the forward's outputs."""
    t, m, kdim, n = shape
    rs = np.random.RandomState(seed)
    w = torch.from_numpy(rs.randint(-3, 4, (kdim, n)).astype(np.float32))
    fw, cfg = _weights(rs, kdim, n)
    fw = macro_lib.pack_kwn_weights(w, fw.scale, cfg)
    x = torch.from_numpy(rs.choice([-1.0, 0.0, 1.0], p=[0.03, 0.94, 0.03],
                                   size=(t, m, kdim)).astype(np.float32))
    x[::3, :, :] = 0.0             # empty steps: gated row tiles
    v0 = torch.from_numpy(rs.uniform(-1, 1.2, (m, n)).astype(np.float32))
    nz = None if noisy else torch.from_numpy(
        rs.choice([-0.05, 0.05], size=(t, m, n)).astype(np.float32))
    kw = dict(k=12, drive_gain=0.25, seed=7, train_trace=True)
    if noisy:
        kw.update(ima_noise=macro_lib.fused_kernel_noise(fw, cfg),
                  snl_amp=0.05)
    outs = ops.fused_macro_seq(x, fw.msb, fw.lsb, fw.boundaries, fw.levels,
                               fw.scale, v0, nz, device=dev, **kw)
    g_spk = torch.from_numpy(rs.randn(t, m, n).astype(np.float32)).to(dev)
    g_vfin = torch.from_numpy(rs.randn(m, n).astype(np.float32)).to(dev)
    mac, _, _, mask, _, vtrace = outs
    return (x.to(dev), w.to(dev), fw.scale.to(dev), mask, vtrace, mac,
            g_spk, g_vfin), outs, (x, fw, v0, nz, kw)


TRAIN_SHAPES = [(30, 64, 512, 128), (7, 37, 300, 100)]
GRAD_KW = dict(drive_gain=0.25, kwn_relax=0.1, ste_lo=-24.5, ste_hi=24.5)


@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=str)
@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
def test_forward_trace_matches_plain_version(cuda, shape, noisy):
    _, got, (x, fw, v0, nz, kw) = _train_operands(shape, noisy, cuda)
    want = ops.fused_macro_seq(x, fw.msb, fw.lsb, fw.boundaries, fw.levels,
                               fw.scale, v0, nz, device="cpu", **kw)
    for name, a, b in zip(("mac", "v_out", "spikes", "mask", "steps",
                           "vtrace"), got, want):
        assert torch.equal(a.cpu(), b), name
    assert _ulps(got[5].cpu(), want[5]) == 0


@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=str)
@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
@pytest.mark.parametrize("remat", [False, True], ids=["residual", "remat"])
@pytest.mark.parametrize("gate", [False, True], ids=["dense", "gated"])
def test_bwd_kernel_matches_plain_version(cuda, shape, noisy, remat, gate):
    res, _, _ = _train_operands(shape, noisy, cuda)
    args = ops.seq_grad_operands(*res, remat=remat, gate=gate)
    before = fused_macro_grad.fused_macro_seq_grad.launches
    dw, dv0 = fused_macro_grad.fused_macro_seq_grad(*args, **GRAD_KW)
    torch.cuda.synchronize()
    assert fused_macro_grad.fused_macro_seq_grad.launches == before + 1
    dw_w, dv0_w = ref.fused_macro_seq_grad_ref(*args, **GRAD_KW)
    assert _ulps(dv0, dv0_w) == 0
    np.testing.assert_allclose(dw.cpu().numpy(), dw_w.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    assert float(dw_w.abs().max()) > 0.0


@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=str)
def test_bwd_kernel_bits_fixed_across_runs_and_policies(cuda, shape):
    res, _, _ = _train_operands(shape, True, cuda)
    outs = []
    for remat, gate in ((False, True), (False, True), (True, True),
                        (False, False), (True, False)):
        args = ops.seq_grad_operands(*res, remat=remat, gate=gate)
        outs.append(fused_macro_grad.fused_macro_seq_grad(*args, **GRAD_KW))
    for dw, dv0 in outs[1:]:
        assert torch.equal(dw, outs[0][0])
        assert torch.equal(dv0, outs[0][1])


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
def test_silicon_loss_and_grads_on_card_equal_cpu(cuda, noisy):
    cfg = snn.SNNConfig(n_in=96, n_hidden=40, n_classes=5, k=6)
    p = snn.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rs = np.random.RandomState(5)
    ev = torch.from_numpy(rs.choice([-1.0, 0.0, 1.0], p=[0.1, 0.8, 0.1],
                                    size=(4, 11, cfg.n_in))
                          .astype(np.float32))
    lab = torch.from_numpy(rs.randint(0, 5, 4))
    noise = ima_lib.IMANoiseModel() if noisy else None
    got = {}
    for dev in (cuda, torch.device("cpu")):
        pd = {k: v.to(dev).requires_grad_(True) for k, v in p.items()}
        before = fused_macro_grad.fused_macro_seq_grad.launches
        loss = snn.loss_fn(pd, ev.to(dev), lab.to(dev), cfg, 9,
                           silicon=True, noise=noise)
        grads = torch.autograd.grad(loss, [pd["w_hid"], pd["w_out"]])
        if dev.type == "cuda":
            assert fused_macro_grad.fused_macro_seq_grad.launches \
                == before + 1
        got[dev.type] = [loss.detach().cpu()] + [g.cpu() for g in grads]
    for a, b in zip(got["cuda"], got["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
@pytest.mark.parametrize("mode", ["kwn", "nld"])
def test_step_path_on_card_equals_seq(cuda, mode, noisy):
    cfg = snn.SNNConfig(n_in=96, n_hidden=40, n_classes=5, k=6, mode=mode,
                        activation="relu")
    p = snn.init_params(cfg, torch.Generator().manual_seed(0), device=cuda)
    rs = np.random.RandomState(6)
    ev = rs.choice([-1.0, 0.0, 1.0], p=[0.1, 0.8, 0.1],
                   size=(4, 9, cfg.n_in)).astype(np.float32)
    noise = ima_lib.IMANoiseModel() if noisy else None
    counter = (fused_macro.fused_macro_seq if mode == "kwn"
               else fused_macro.fused_macro_seq_nld)
    before = counter.launches
    ls, ts = snn.forward_silicon(p, ev, cfg, seed=3, noise=noise,
                                 fused="step", device=cuda)
    assert counter.launches == before + 9
    lq, tq = snn.forward_silicon(p, ev, cfg, seed=3, noise=noise,
                                 fused="seq", device=cuda)
    assert torch.equal(ls, lq)
    for key in tq:
        assert torch.equal(ts[key], tq[key]), key
