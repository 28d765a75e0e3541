"""Tests of the port that need the card (marker ``cuda``).

They import neither JAX nor ``repro`` (the GPU machine has no JAX), and
they skip with a reason where no CUDA device is present.  On the GPU
(``--noconftest``: ``tests/conftest.py`` imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import dendrite as dendrite_lib
from repro_torch.core import f32math
from repro_torch.core import ima as ima_lib
from repro_torch.core import macro as macro_lib
from repro_torch.core import prbs as prbs_lib
from repro_torch.configs import base as lm_base
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as kernels_flash
from repro_torch.kernels import fused_macro, fused_macro_grad, ops, ref
from repro_torch.kernels import kwn_topk as kernels_kwn
from repro_torch.kernels import lif_step as kernels_lif
from repro_torch.kernels import nlq_lut as kernels_nlq
from repro_torch.kernels import ternary_mac as kernels_tmac
from repro_torch.models import lm, snn
from repro_torch.nn import module as nn_module
from repro_torch.train import optim
from repro_torch.train import train_loop
from repro_torch.tune import autotune

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


# the winner counts of the paper's K sweep (experiments_torch)
EXP_KS = (1, 3, 6, 12, 24, 48)


@pytest.mark.parametrize("k", EXP_KS)
@pytest.mark.parametrize("shape", [(8, 64, 512, 128), (6, 37, 300, 200),
                                   # N-MNIST and DVS-Gesture evaluation
                                   (20, 128, 512, 128), (30, 128, 512, 128)],
                         ids=str)
@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
def test_kernel_matches_plain_version(cuda, shape, noisy, k):
    """#1 equals its plain version at every K of the sweep, and no item's
    ADC steps fall from the sweep's previous K to this one."""
    t, m, kdim, n = shape
    rs = np.random.RandomState(0)
    fw, cfg = _weights(rs, kdim, n)
    x = torch.from_numpy(rs.choice([-1.0, 0.0, 1.0], p=[0.05, 0.9, 0.05],
                                   size=(t, m, kdim)).astype(np.float32))
    v0 = torch.from_numpy(rs.uniform(-1, 1.2, (m, n)).astype(np.float32))
    nz = None if noisy else torch.from_numpy(
        rs.choice([-0.05, 0.05], size=(t, m, n)).astype(np.float32))
    kw = dict(k=k, drive_gain=0.25, seed=7, step_offset=2)
    if noisy:
        kw.update(ima_noise=macro_lib.fused_kernel_noise(fw, cfg),
                  snl_amp=0.05)
    args = (x, *fw[:2], fw.boundaries, fw.levels, fw.scale, v0, nz)
    before = fused_macro.fused_macro_seq.launches
    got = ops.fused_macro_seq(*args, device=cuda, **kw)
    torch.cuda.synchronize()
    assert fused_macro.fused_macro_seq.launches == before + 1
    want = ops.fused_macro_seq(*args, device="cpu", **kw)
    for name, a, b in zip(("mac", "v_out", "spikes", "mask", "steps"),
                          got, want):
        assert torch.equal(a.cpu(), b), name
    assert int(want[3].sum(-1).max()) <= k
    if k > EXP_KS[0]:
        prev = ops.fused_macro_seq(
            *args, device="cpu",
            **dict(kw, k=EXP_KS[EXP_KS.index(k) - 1]))
        assert bool((want[4] >= prev[4]).all())


SEQ_KWN_SHAPES = [(t, m, n) for t in (1, 8, 30) for m in (4, 64, 132)
                  for n in (32, 128, 200, 1024)]
# (counter noise, activity map, training trace): each flag on and off, and
# each pair of flags in both combinations, at every shape
SEQ_KWN_VARIANTS = [(False, False, False), (True, True, True),
                    (True, False, False), (False, True, True)]


def _bits(a: torch.Tensor) -> torch.Tensor:
    return a.contiguous().view(torch.int32)


@pytest.mark.parametrize("variant", SEQ_KWN_VARIANTS,
                         ids=lambda v: "-".join(
                             ("noisy" if v[0] else "clean",
                              "gated" if v[1] else "dense",
                              "trace" if v[2] else "serve")))
@pytest.mark.parametrize("shape", SEQ_KWN_SHAPES, ids=str)
def test_seq_kwn_kernel_bit_exact_to_plain_version(cuda, shape, variant):
    """Kernel #1 through its wrapper on operands padded to the tile plan
    (K 300 -> 512: a ragged K tile; N = 200 -> 256 with 56 columns of code
    -1; N = 1024 = MAX_COLS, eight column tiles of staged planes; M = 132
    -> 256, two row tiles), with per-row ``row_ctl`` (distinct seeds, step
    offsets and row ids), against ``ref.fused_macro_seq_kwn_ref`` on the same
    card tensors: every output equal, membranes and the trace at 0 ULP."""
    t, m, n = shape
    noisy, gated, trace = variant
    kdim = 300
    rs = np.random.RandomState(t * 10000 + m * 10 + n)
    fw, cfg = _weights(rs, kdim, n)
    plan = fused_macro.plan_tiles(m, kdim, n, n, t)
    pad = torch.nn.functional.pad
    mp, kp, np_ = plan.m_pad, plan.k_pad, plan.n_pad
    x = rs.choice([-1, 0, 1], p=[0.04, 0.92, 0.04], size=(t, m, kdim))
    x[::2, :, :256] = 0              # a quiet K tile on even steps
    x = pad(torch.from_numpy(x.astype(np.int8)),
            (0, kp - kdim, 0, mp - m)).to(cuda)
    v0 = pad(torch.from_numpy(rs.uniform(-1, 1.2, (m, n))
                              .astype(np.float32)), (0, np_ - n, 0, mp - m))
    rc = pad(torch.from_numpy(np.stack(
        [rs.randint(0, 2 ** 31 - 1, m), rs.randint(0, 50, m),
         rs.randint(0, 4 * m, m)], -1).astype(np.int32)), (0, 0, 0, mp - m))
    nz = None if noisy else pad(torch.from_numpy(
        rs.choice([-0.05, 0.05], size=(t, m, n)).astype(np.float32)),
        (0, np_ - n, 0, mp - m)).to(cuda)
    kw = dict(k=12, drive_gain=0.25, train_trace=trace, n_valid=n)
    if noisy:
        kw.update(ima_noise=macro_lib.fused_kernel_noise(fw, cfg),
                  snl_amp=0.05)
    planes = [pad(a, (0, np_ - n, 0, kp - kdim)).contiguous().to(cuda)
              for a in (fw.msb, fw.lsb)]
    args = (x, *planes, fw.boundaries.to(cuda), fw.levels.to(cuda),
            pad(fw.scale, (0, np_ - n)).to(cuda), v0.to(cuda), nz)
    activity = ops.fused_activity_map(x, plan) if gated else None
    before = fused_macro.fused_macro_seq.launches
    got = fused_macro.fused_macro_seq(*args, activity=activity,
                                      row_ctl=rc.to(cuda),
                                      bm=plan.bm, bk=plan.bk, **kw)
    torch.cuda.synchronize()
    assert fused_macro.fused_macro_seq.launches == before + 1
    want = ref.fused_macro_seq_kwn_ref(*args, row_ctl=rc.to(cuda), **kw)
    names = ("mac", "v_out", "spikes", "mask", "steps", "vtrace")
    assert len(got) == len(want) == (6 if trace else 5)
    for name, a, b in zip(names, got, want):
        assert torch.equal(_bits(a), _bits(b)), name
    assert int(want[3].sum()) > 0


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
                                   (5, 13, 96, 50, 3, "quadratic"),
                                   # J*N = 100 <= 128: no padding, neuron
                                   # p's branches on different lanes
                                   (7, 16, 96, 50, 2, "relu"),
                                   # J*N = 1024, the training length
                                   (30, 64, 512, 512, 2, "relu"),
                                   # more branches than the LIF holds in
                                   # registers
                                   (4, 13, 96, 24, 6, "sigmoid4"),
                                   # the N-MNIST, DVS-Gesture and Quiroga
                                   # evaluation configurations
                                   (20, 128, 512, 128, 2, "quadratic"),
                                   (30, 128, 512, 128, 2, "relu"),
                                   (24, 128, 256, 128, 2, "sigmoid4")],
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
                                   (5, 13, 96, (40, 200, 20), (4, 12, 3)),
                                   (6, 16, 128, (200, 128, 20), (12, 12, 3)),
                                   (8, 32, 256, (256,), (12,)),
                                   (6, 24, 128, (128, 200, 64, 20),
                                    (12, 12, 6, 3)),
                                   (3, 8, 64, (512, 512, 512), (4, 4, 4)),
                                   (30, 64, 512, (1024, 200), (24, 12))],
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
                  snl_amp=0.05, seeds=[5, 6, 7, 8][:len(widths)],
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


def test_stack_wider_than_the_old_register_limit_equals_plain(cuda):
    """Three 512-column layers (48 register columns a lane in the earlier
    one-warp-a-row kernel, which refused them) through the split kernels,
    clean and noisy, against the plain version; a fifth layer still
    raises."""
    rs = np.random.RandomState(3)
    stack, cfg = _stack(rs, 64, (512, 512, 512))
    x = torch.from_numpy(rs.choice([-1.0, 0.0, 1.0], p=[0.1, 0.8, 0.1],
                                   size=(3, 8, 64)).astype(np.float32))
    vs = [torch.from_numpy(rs.uniform(-1, 1.2, (8, 512)).astype(np.float32))
          for _ in range(3)]
    for kw in (dict(), dict(ima_noise=macro_lib.fused_kernel_noise(
            stack[0], cfg), snl_amp=0.05, seeds=[1, 2, 3], step_offset=5)):
        got = macro_lib.fused_multi_seq(x.to(cuda), stack, vs, None,
                                        ks=(4, 4, 4), **kw)
        want = macro_lib.fused_multi_seq(x, stack, vs, None, ks=(4, 4, 4),
                                         **kw)
        for name in ("v_outs", "steps", "spike_counts", "occupancy"):
            for a, b in zip(getattr(got, name), getattr(want, name)):
                assert torch.equal(a.cpu(), b), name
        assert torch.equal(got.spikes.cpu(), want.spikes)
        assert torch.equal(got.mask.cpu(), want.mask)
        assert sum(float(c.sum()) for c in want.spike_counts[:-1]) > 0
    five = stack + stack[1:3]
    with pytest.raises(ValueError, match="1..4 layers"):
        macro_lib.fused_multi_seq(x.to(cuda), five, vs + vs[1:], None,
                                  ks=(4,) * 5)


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


TRAIN_SHAPES = [(30, 64, 512, 128), (7, 37, 300, 100), (8, 64, 300, 200)]
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


@pytest.mark.parametrize("remat", [False, True], ids=["residual", "remat"])
@pytest.mark.parametrize("shape", [(30, 64, 512, 128), (4, 16, 256, 1024)],
                         ids=str)
def test_bwd_kernel_dw_bits_fixed_over_five_launches(cuda, shape, remat):
    """Kernel #3's contraction adds fixed row slices in a fixed order, with
    no atomics: five launches give the same dW and dv0 bits, at the
    training shape and at MAX_COLS (eight column tiles of the remat
    MAC)."""
    res, _, _ = _train_operands(shape, True, cuda)
    args = ops.seq_grad_operands(*res, remat=remat, gate=True)
    outs = [fused_macro_grad.fused_macro_seq_grad(*args, **GRAD_KW)
            for _ in range(5)]
    for dw, dv0 in outs[1:]:
        assert torch.equal(_bits(dw), _bits(outs[0][0]))
        assert torch.equal(_bits(dv0), _bits(outs[0][1]))
    dw_w, dv0_w = ref.fused_macro_seq_grad_ref(*args, **GRAD_KW)
    assert _ulps(outs[0][1], dv0_w) == 0
    np.testing.assert_allclose(outs[0][0].cpu().numpy(),
                               dw_w.cpu().numpy(), rtol=1e-5, atol=1e-6)


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


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
@pytest.mark.parametrize("mode", ["kwn", "nld"])
def test_kernel_level_step_equals_its_oracles(cuda, mode, noisy):
    """``fused_macro.fused_macro_step`` launches #1 / #2 once and equals
    ``ref.fused_macro_step_ref`` and ``ref.fused_macro_tiled_ref`` (a
    ragged 96 x 40 tiling) on the same card tensors, bit for bit."""
    rs = np.random.RandomState(21)
    m, kdim, n = 16, 256, 40
    if mode == "kwn":
        fw, cfg = _weights(rs, kdim, n)
        w_dend, kw = None, dict(k=6)
    else:
        cfg = macro_lib.CIMMacroConfig(code_bits=5, mac_range=4.0,
                                       ima_noise=ima_lib.IMANoiseModel())
        fw = macro_lib.pack_nld_weights(dendrite_lib.dendrite_init(
            torch.Generator().manual_seed(2), kdim, n, 3, device=cuda), cfg,
            "relu")
        w_dend, kw = fw.w_dend.to(cuda), {}
    if noisy:
        kw.update(ima_noise=macro_lib.fused_kernel_noise(fw, cfg),
                  snl_amp=0.05, seed=99)
    x = torch.from_numpy(rs.choice([-1, 0, 1], p=[0.1, 0.8, 0.1],
                                   size=(m, kdim)).astype(np.int8))
    v = torch.from_numpy(rs.uniform(-1, 1.2, (m, n)).astype(np.float32))
    args = [a.to(cuda) for a in (x, fw.msb, fw.lsb, fw.boundaries,
                                 fw.levels, fw.scale, v)]
    kw.update(mode=mode, drive_gain=0.25)
    counter = (fused_macro.fused_macro_seq if mode == "kwn"
               else fused_macro.fused_macro_seq_nld)
    before = counter.launches
    got = fused_macro.fused_macro_step(*args, None, w_dend, bm=16, bk=128,
                                       step_offset=4, device=cuda, **kw)
    assert counter.launches == before + 1
    for want in (ref.fused_macro_step_ref(*args, None, w_dend, step=4, **kw),
                 ref.fused_macro_tiled_ref(*args, None, w_dend, bk=96,
                                           bn=40, step=4, **kw)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


# --- the composed chain: the four single-stage kernels ------------------------

STAGE_SHAPES = [(64, 512, 128), (128, 256, 128), (37, 300, 100)]
LIF_KW = dict(beta=0.9, v_th1=1.0, v_th2=0.6, v_reset=0.0, v_lim=8.0)


def _codebook(kind, bits):
    if kind == "nlq":
        return ima_lib.nlq_codebook(bits, -24.0, 24.0)
    if kind == "linear":
        return ima_lib.linear_codebook(bits, -24.0, 24.0)
    return ima_lib.activation_codebook(bits, ima_lib.quadratic, -4.0, 4.0)


def _tern(rs, *shape):
    return torch.from_numpy(rs.randint(-1, 2, size=shape).astype(np.int8))


def _same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu(), b), (a.cpu() != b).sum()


# the edges of #5's split-K tensor-core design: one row, a ragged row
# tile, no K, one and one-and-a-half mma steps, eight slices of 128, a
# column tile of 8, ragged N, 32 column tiles, the stack chain's layer 2
TMAC_EDGE_SHAPES = [(1, 512, 128), (17, 512, 128), (64, 0, 128),
                    (64, 32, 128), (64, 48, 128), (64, 1000, 128),
                    (64, 512, 8), (64, 512, 100), (64, 512, 1024),
                    (64, 128, 128)]


@pytest.mark.parametrize("ratio", [2.0, 3.0, 2.05])
@pytest.mark.parametrize("density", [0.05, 0.67])
@pytest.mark.parametrize("shape", STAGE_SHAPES + TMAC_EDGE_SHAPES, ids=str)
def test_ternary_mac_kernel_matches_plain_version(cuda, shape, density,
                                                  ratio):
    m, k, n = shape
    rs = np.random.RandomState(m)
    x = torch.from_numpy(rs.choice(
        [-1, 0, 1], p=[density / 2, 1 - density, density / 2],
        size=(m, k)).astype(np.int8))
    msb, lsb = _tern(rs, k, n), _tern(rs, k, n)
    before = kernels_tmac.ternary_mac.launches
    got = ops.ternary_mac(x, msb, lsb, ratio=ratio, device=cuda)
    torch.cuda.synchronize()
    assert kernels_tmac.ternary_mac.launches == before + 1
    _same([got], [ops.ternary_mac(x, msb, lsb, ratio=ratio, device="cpu")])


KINDS = ("nlq", "linear", "activation")
# #6 at the chain's shapes and at the edges of its design: (M, N), the
# codebook's kind and bits, the boundaries' order, the operands' offset
# in elements (not 16-byte aligned for 1-3); totals that are not a
# multiple of 4, and one shape beyond the L2
NLQ_CASES = (
    [((m, n), kind, bits, "sorted", 0) for m, _, n in STAGE_SHAPES
     for kind in KINDS for bits in (5, 6)]
    + [(shape, kind, bits, "sorted", 0) for shape in ((64, 128), (5, 101))
       for kind in KINDS for bits in (1, 2, 8)]
    + [((64, 128), "nlq", bits, order, 0) for bits, order in (
        (5, "permuted"), (6, "permuted"), (8, "permuted"),
        (5, "descending"), (5, "nan_boundary"))]
    + [((37, n), "nlq", 5, "sorted", offset) for n in (128, 100)
       for offset in (1, 2, 3)]
    + [(shape, "linear", 5, "sorted", 0)
       for shape in ((1, 1), (3, 7), (1, 2049), (9, 999), (64, 0))]
    + [((8192, 1024), "nlq", 5, "sorted", 0)]
    + [(shape, kind, bits, "zero_boundary", 0)
       for shape in ((64, 128), (5, 101))
       for kind, bits in (("nlq", 5), ("linear", 6))])


@pytest.fixture
def smoke():
    """``chip_smoke.py``'s builders of card operands (``_on_card``,
    ``_ramp_edges``, ``_lif_operands``), imported once the card is
    found."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def _ordered(bounds, order, rs):
    """The boundaries as they are, permuted, reversed, with a NaN, or with
    the middle one (within an ULP of 0) set to 0."""
    if order == "zero_boundary":
        return bounds.clone().index_fill_(
            0, torch.tensor([bounds.numel() // 2]), 0.0)
    if order == "permuted":
        return bounds[torch.from_numpy(rs.permutation(bounds.numel()))]
    if order == "descending":
        return bounds.flip(0)
    if order == "nan_boundary":
        return bounds.clone().index_fill_(0, torch.tensor([7]), float("nan"))
    return bounds


@pytest.mark.parametrize(
    "case", NLQ_CASES,
    ids=lambda c: f"{c[0][0]}x{c[0][1]}-{c[1]}-{c[2]}bit-{c[3]}-off{c[4]}")
def test_nlq_kernel_matches_plain_version(cuda, smoke, case):
    """Values across the codebook's span with NaN, +-inf, +-0, every
    boundary and its f32 neighbours and subnormals of both signs planted,
    against the plain version on the same card tensors (the linear count
    for the unsorted codebooks; 8 bits: the codebook in shared memory;
    a boundary of 0, where a subnormal counts as a zero)."""
    shape, kind, bits, order, offset = case
    rs = np.random.RandomState(bits + 10 * offset)
    cb = _codebook(kind, bits)
    x = smoke._ramp_edges(rs, cb.boundaries, shape,
                          5.0 if kind == "activation" else 30.0, cuda, offset)
    bounds = _ordered(cb.boundaries, order, rs).to(cuda)
    levels = cb.levels.to(cuda)
    before = kernels_nlq.nlq_convert.launches
    got = ops.nlq_convert(x, bounds, levels, device=cuda)
    torch.cuda.synchronize()
    assert kernels_nlq.nlq_convert.launches == before + 1
    _same(got, [t.cpu() for t in ref.nlq_convert_ref(x, bounds, levels)])


@pytest.mark.parametrize("edges", ["ties", "subnormal"])
@pytest.mark.parametrize("bits", [5, 6])
@pytest.mark.parametrize("k", [0, 1, 12, "N", "N+5"])
@pytest.mark.parametrize("shape", STAGE_SHAPES + [(16, 0, 256),
                                                  (64, 0, 1024)], ids=str)
def test_kwn_kernel_matches_plain_version(cuda, smoke, shape, k, bits,
                                          edges):
    """Integral MACs with every boundary planted (ties), or with
    subnormals of both signs planted against the codebook with its middle
    boundary set to 0."""
    m, _, n = shape
    k = {"N": n, "N+5": n + 5}.get(k, k)
    rs = np.random.RandomState(n)
    cb = _codebook("nlq", bits)
    mac = torch.from_numpy(np.round(rs.normal(0, 10, (m, n)))
                           .astype(np.float32))
    if edges == "ties":
        mac.view(-1)[:cb.boundaries.numel()] = cb.boundaries
    else:
        cb = cb._replace(boundaries=_ordered(cb.boundaries, "zero_boundary",
                                             rs))
        sub = torch.from_numpy(smoke.SUBNORMALS)
        mac.view(-1)[:sub.numel()] = sub[:mac.numel()]
    before = kernels_kwn.kwn_topk.launches
    got = ops.kwn_topk(mac, cb.boundaries, k, device=cuda)
    torch.cuda.synchronize()
    assert kernels_kwn.kwn_topk.launches == before + 1
    _same(got, ops.kwn_topk(mac, cb.boundaries, k, device="cpu"))


# #8 at the chain's shapes, on views offset by 1-3 elements (not 16-byte
# aligned) and beyond the L2: (M, N), offset
LIF_CASES = ([((m, n), 0) for m, _, n in STAGE_SHAPES + [(3, 0, 7)]]
             + [(shape, offset) for shape in ((64, 128), (37, 100), (3, 7))
                for offset in (1, 2, 3)]
             + [((8192, 1024), 0)])


@pytest.mark.parametrize("use_snl", [True, False], ids=["snl", "no_snl"])
@pytest.mark.parametrize("case", LIF_CASES,
                         ids=lambda c: f"{c[0][0]}x{c[0][1]}-off{c[1]}")
def test_lif_kernel_matches_plain_version(cuda, smoke, case, use_snl):
    shape, offset = case
    args = smoke._lif_operands(np.random.RandomState(sum(shape) + offset),
                               shape, cuda, offset)
    before = kernels_lif.lif_step_fused.launches
    got = ops.lif_step(*args, use_snl=use_snl, device=cuda, **LIF_KW)
    torch.cuda.synchronize()
    assert kernels_lif.lif_step_fused.launches == before + 1
    _same(got, [t.cpu() for t in ref.lif_step_ref(*args, use_snl=use_snl,
                                                  **LIF_KW)])


def _chain(ev_t, fw, v, noise, k, drive_gain, dev):
    """The four-kernel chain over a (T, B, I) sequence: spikes (T, B, N),
    ADC steps (T, B) and the final membrane."""
    spikes, steps = [], []
    for t in range(ev_t.shape[0]):
        mac = ops.ternary_mac(ev_t[t], fw.msb, fw.lsb, device=dev)
        _, mac_q = ops.nlq_convert(mac, fw.boundaries, fw.levels, device=dev)
        mask, st = ops.kwn_topk(mac, fw.boundaries, k, device=dev)
        drive = mac_q * fw.scale * mask * drive_gain
        v, spk = ops.lif_step(v, drive, mask, noise[t], device=dev, **LIF_KW)
        spikes.append(spk)
        steps.append(st)
    return torch.stack(spikes), torch.stack(steps), v


def test_chain_equals_fused_seq_and_composed_forward(cuda):
    """The chain on the card, with the model's planes and PRBS noise,
    equals ``ops.fused_macro_seq`` on the same operands (spikes, ADC
    steps, membranes) and ``forward_silicon(fused=False)`` (spike counts
    through an identity readout, mean ADC steps) bit for bit; each kernel
    launches once a step."""
    cfg = snn.SNNConfig(n_in=96, n_hidden=40, n_classes=40, k=6)
    p = snn.init_params(cfg, torch.Generator().manual_seed(0), device=cuda)
    p["w_out"] = torch.eye(cfg.n_hidden, device=cuda)
    rs = np.random.RandomState(3)
    b, t = 8, 10
    ev = rs.choice([-1.0, 0.0, 1.0], p=[0.1, 0.8, 0.1],
                   size=(b, t, cfg.n_in)).astype(np.float32)
    fw = snn.pack_fused(p, cfg)
    ev_t = torch.from_numpy(ev).to(cuda).transpose(0, 1)
    noise = prbs_lib.sequence_noise(b, t, cfg.n_hidden, cfg.noise_amp, cuda)
    v0 = torch.zeros((b, cfg.n_hidden), device=cuda)
    counters = (kernels_tmac.ternary_mac, kernels_nlq.nlq_convert,
                kernels_kwn.kwn_topk, kernels_lif.lif_step_fused)
    before = [c.launches for c in counters]
    spk, steps, v = _chain(ev_t, fw, v0, noise, cfg.k, cfg.drive_gain, cuda)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [t] * 4
    _, v_f, spk_f, _, st_f = ops.fused_macro_seq(
        ev_t, fw.msb, fw.lsb, fw.boundaries, fw.levels, fw.scale, v0, noise,
        k=cfg.k, drive_gain=cfg.drive_gain, device=cuda)
    assert torch.equal(spk, spk_f) and torch.equal(steps, st_f)
    assert torch.equal(v, v_f)
    logits, tele = snn.forward_silicon(p, ev, cfg, fused=False, device=cuda)
    assert torch.equal(logits, f32math.div(spk.sum(0), t))
    assert torch.equal(tele["adc_steps"],
                       f32math.div(steps.float().sum(0), t))
    assert spk.sum() > 0


@pytest.mark.parametrize("kind", ["kwn", "nld", "stack"])
def test_composed_forward_on_card_equals_cpu(cuda, kind):
    if kind == "nld":
        cfg = snn.SNNConfig(n_in=96, n_hidden=40, n_classes=5, mode="nld",
                            n_branches=2, activation="relu")
    elif kind == "stack":
        cfg = snn.SNNConfig(n_in=96, n_classes=5, hidden_layers=(64, 48),
                            k_layers=(6, 5))
    else:
        cfg = snn.SNNConfig(n_in=96, n_hidden=40, n_classes=5, k=6)
    p = snn.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rs = np.random.RandomState(5)
    ev = rs.choice([-1.0, 0.0, 1.0], p=[0.1, 0.8, 0.1],
                   size=(4, 11, cfg.n_in)).astype(np.float32)
    (lg, tg), (lc, tc) = (
        snn.forward_silicon(p, ev, cfg, fused=False, device=dev)
        for dev in (cuda, "cpu"))
    for key in ("adc_steps", "lif_updates", "sops"):
        assert torch.equal(tg[key].cpu(), tc[key]), key
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-5,
                               atol=1e-6)


# --- kernel #9: flash attention ---------------------------------------------

FLASH_SHAPES = [(8, 128, 16), (8, 192, 32), (16, 1000, 64), (72, 2048, 64),
                (8, 2048, 128)]


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ULP at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(torch.clamp(x.abs(), min=2.0 ** -126)))
    return torch.exp2(e - 7)


def _flash_inputs(shape, dtype, dev, scale=1.0, seed=0):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32))
            .to(dev, dtype) for _ in range(3)]


@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_matches_plain_version(cuda, shape, causal, dtype):
    """f32 at rtol = atol = 2e-5 (the JAX suite's); bf16 against the plain
    version's f32 result from the same bf16 inputs, rounded: within one
    bf16 ULP, or 2e-5 where the output cancels to near zero."""
    q, k, v = _flash_inputs(shape, dtype, cuda)
    before = kernels_flash.flash_attention_fwd.launches
    got = kernels_flash.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernels_flash.flash_attention_fwd.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal)
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        g, w = got.float(), want.float()
        tol = torch.clamp(_bf16_ulp(torch.maximum(g.abs(), w.abs())),
                          min=2e-5)
        assert bool(((g - w).abs() <= tol).all())


def test_flash_kernel_large_logits(cuda):
    """Integer-valued inputs x30 (scores up to ~1e3, exact in any sum
    order): finite, and equal to the plain version at the f32 tolerance."""
    q, k, v = (torch.round(t) for t in _flash_inputs(
        (4, 1000, 64), torch.float32, cuda, scale=30.0, seed=11))
    got = kernels_flash.flash_attention_fwd(q, k, v, causal=True)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, True),
                               rtol=2e-5, atol=2e-5)


def _assert_flash_gate(got, want, dtype):
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        g, w = got.float(), want.float()
        tol = torch.clamp(_bf16_ulp(torch.maximum(g.abs(), w.abs())),
                          min=2e-5)
        assert bool(((g - w).abs() <= tol).all())


@pytest.mark.parametrize("d", [21, 80, 112, 192, 256])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_takes_every_head_dim(cuda, d, causal, dtype):
    """Head dims padded inside the kernel's tiles (21 -> 32, 112, 192 and
    256 on their own widths; 21 also takes the element-wise load path),
    under the same gates, at a ragged S."""
    q, k, v = _flash_inputs((4, 1000, d), dtype, cuda, seed=d)
    got = kernels_flash.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _assert_flash_gate(got, ref.flash_attention_ref(q, k, v, causal), dtype)


@pytest.mark.parametrize("d", [64, 192])
def test_flash_kernel_rows_not_16_byte_aligned(cuda, d):
    """A view one element into its storage: the bf16 kernel cannot use the
    tensor maps there and loads element by element, with the same result
    gate."""
    rs = np.random.RandomState(d)
    flat = torch.from_numpy(rs.randn(3 * 4 * 300 * d + 1).astype(
        np.float32)).to(cuda, torch.bfloat16)
    q, k, v = (flat[1 + i * 4 * 300 * d:1 + (i + 1) * 4 * 300 * d]
               .view(4, 300, d) for i in range(3))
    assert q.data_ptr() % 16 != 0
    got = kernels_flash.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    _assert_flash_gate(got, ref.flash_attention_ref(q, k, v, True),
                       torch.bfloat16)


@pytest.mark.parametrize("d", [21, 256])
def test_flash_kernel_large_logits_at_head_dims(cuda, d):
    q, k, v = (torch.round(t) for t in _flash_inputs(
        (2, 1000, d), torch.float32, cuda, scale=30.0, seed=12))
    got = kernels_flash.flash_attention_fwd(q, k, v, causal=True)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, True),
                               rtol=2e-5, atol=2e-5)


def test_refused_launch_raises_runtime_error(cuda):
    """A launch CUDA refuses (here more dynamic shared memory than the
    NLQ kernel may take without opting in) never runs; the wrapper raises
    instead of returning an unwritten output."""
    x = torch.zeros((4, 4), device=cuda)
    n_codes = 16384                          # 128 KB of shared memory
    with pytest.raises(RuntimeError, match="nlq_lut launch failed"):
        kernels_nlq.nlq_convert(
            x, torch.linspace(-1, 1, n_codes - 1, device=cuda),
            torch.zeros(n_codes, device=cuda))


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((2, 64, 257), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        kernels_flash.flash_attention_fwd(q, q, q)
    q = torch.zeros((2, 64, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        kernels_flash.flash_attention_fwd(q, q, q)


def test_lm_forward_launches_flash_once_per_layer(cuda):
    """Full smollm-135m width (30 layers, bf16) at a short sequence: one
    flash launch per layer for the full forward and for prefill; decode
    launches none."""
    cfg = get_config("smollm-135m")
    params = nn_module.materialize(lm.param_specs(cfg),
                                   torch.Generator().manual_seed(0),
                                   device=cuda)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 70))).to(cuda)
    for prefill in (False, True):
        before = kernels_flash.flash_attention_fwd.launches
        out = lm.forward(params, {"tokens": toks}, cfg, prefill=prefill)
        torch.cuda.synchronize()
        assert kernels_flash.flash_attention_fwd.launches - before == 30
        assert bool(torch.isfinite(out[0]).all())
    cache = lm.pad_cache(out[2], cfg, 80)
    before = kernels_flash.flash_attention_fwd.launches
    logits, _ = lm.decode_step(params, cache, toks[:, :1],
                               torch.full((2,), 70, device=cuda), cfg)
    assert kernels_flash.flash_attention_fwd.launches == before
    assert logits.shape == (2, cfg.padded_vocab)


def test_lm_prefill_at_head_dim_192_on_card_equals_cpu(cuda):
    """nemotron-4-340b reduced to d_model 768 over 4 heads (head_dim 192,
    the config's own): the prefill launches the flash kernel once a layer,
    and its logits equal the CPU's in f32."""
    cfg = lm_base.reduced(get_config("nemotron-4-340b"), d_model=768)
    assert cfg.hd == 192
    p_cpu = nn_module.materialize(lm.param_specs(cfg),
                                  torch.Generator().manual_seed(0),
                                  device="cpu")
    p_gpu = nn_module.tree_map(lambda t: t.to(cuda), p_cpu)
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (2, 70)))
    before = kernels_flash.flash_attention_fwd.launches
    got = lm.forward(p_gpu, {"tokens": toks.to(cuda)}, cfg, prefill=True)
    torch.cuda.synchronize()
    assert kernels_flash.flash_attention_fwd.launches - before == \
        cfg.n_layers
    want = lm.forward(p_cpu, {"tokens": toks}, cfg, prefill=True)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2.5-32b"])
def test_lm_forward_and_decode_on_card_equal_cpu(cuda, arch):
    """Reduced configs in f32: the card's kernel and cuBLAS sums against
    the CPU's plain versions, logits within rtol = atol = 1e-5."""
    cfg = lm_base.reduced(get_config(arch))
    p_cpu = nn_module.materialize(lm.param_specs(cfg),
                                  torch.Generator().manual_seed(0),
                                  device="cpu")
    p_gpu = nn_module.tree_map(lambda t: t.to(cuda), p_cpu)
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (2, 37)))
    outs = [lm.forward(p, {"tokens": toks.to(dev)}, cfg, prefill=True)
            for p, dev in ((p_gpu, cuda), (p_cpu, "cpu"))]
    torch.testing.assert_close(outs[0][0].cpu(), outs[1][0], rtol=1e-5,
                               atol=1e-5)
    steps = []
    for (_, _, cache), p, dev in zip(outs, (p_gpu, p_cpu), (cuda, "cpu")):
        cache = lm.pad_cache(cache, cfg, 40)
        logits, _ = lm.decode_step(p, cache, toks[:, :1].to(dev),
                                   torch.full((2,), 37, device=dev), cfg)
        steps.append(logits.cpu())
    torch.testing.assert_close(steps[0], steps[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["gemma2-2b", "recurrentgemma-9b",
                                  "xlstm-350m"])
def test_lm_family_on_card_equals_cpu(cuda, smoke, arch):
    """Reduced gemma2, recurrentgemma and xlstm in f32 (window 32):
    forward, prefill at two windows with every cache entry, 8 decode
    steps, the int8 and int4 caches on gemma2 and a 4-slot engine, on
    the card against the CPU (``chip_smoke.reduced_family_phase``:
    within 1e-5, xlstm within four times its own rounding change)."""
    res = smoke.reduced_family_phase(arch, cuda)
    for key in ("forward", "prefill", "cache", "decode"):
        assert res[key] <= res["tol"], key


def test_recurrentgemma_local_layers_launch_flash_within_a_window(cuda):
    """recurrentgemma's 38-layer pattern (12 local attention layers) at
    reduced width: a prefill over at most a window launches the flash
    kernel once a local layer; over two windows the sliding-window plain
    path launches none, and decode launches none."""
    cfg = lm_base.reduced(get_config("recurrentgemma-9b"), n_layers=38)
    params = nn_module.materialize(lm.param_specs(cfg),
                                   torch.Generator(cuda).manual_seed(0),
                                   device=cuda)
    rs = np.random.RandomState(4)
    for s, want in ((cfg.window, 12), (2 * cfg.window, 0)):
        toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (4, s)))
        before = kernels_flash.flash_attention_fwd.launches
        logits, _, cache = lm.forward(params, {"tokens": toks.to(cuda)}, cfg,
                                      prefill=True)
        torch.cuda.synchronize()
        assert kernels_flash.flash_attention_fwd.launches - before == want
        assert bool(torch.isfinite(logits).all())
    before = kernels_flash.flash_attention_fwd.launches
    logits, _ = lm.decode_step(params, cache, toks[:, :1].to(cuda),
                               torch.full((4,), s, device=cuda), cfg)
    assert kernels_flash.flash_attention_fwd.launches == before
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "arctic-480b",
                                  "internvl2-26b", "hubert-xlarge"])
def test_lm_moe_and_frontends_on_card_equal_cpu(cuda, smoke, arch):
    """Reduced kimi-k2, arctic, internvl2 and hubert in f32: forward and
    prefill (logits, aux loss, caches, every router's experts equal, the
    flash kernel once a layer, hubert's non-causal), 4 decode steps, on
    the card against the CPU within 1e-5; prefill against teacher-forced
    decode within 2e-3 and a 4-slot engine
    (``chip_smoke.reduced_moe_phase``)."""
    res = smoke.reduced_moe_phase(arch, cuda)
    for key in ("forward", "aux", "prefill", "cache", "decode"):
        assert res[key] <= 1e-5, key
    cfg = lm_base.reduced(get_config(arch))
    assert res["flash_launches"] == 2 * cfg.n_layers
    assert res["router_calls"] == (2 * cfg.n_layers if cfg.moe else 0)
    assert res.get("decode_refused", False) == cfg.encoder_only


@pytest.mark.parametrize("shape,causal", [((128, 1024, 80), False),
                                          ((64, 1024, 112), True),
                                          ((56, 1024, 128), True),
                                          ((48, 2048, 128), True)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_at_moe_and_frontend_shapes(cuda, shape, causal, dtype):
    """The prefill shapes of the four configurations at full width:
    hubert's non-causal D = 80 (BH 16 x 8), kimi-k2's D = 112 (BH 64),
    arctic's D = 128 (BH 56) and internvl2's D = 128 over 2048 positions
    (BH 48), under the flash gates."""
    q, k, v = _flash_inputs(shape, dtype, cuda, seed=shape[2])
    before = kernels_flash.flash_attention_fwd.launches
    got = kernels_flash.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernels_flash.flash_attention_fwd.launches == before + 1
    _assert_flash_gate(got, ref.flash_attention_ref(q, k, v, causal), dtype)


TRAIN_CASES = [(arch, {}) for arch in (
    "arctic-480b", "gemma2-2b", "hubert-xlarge", "internvl2-26b",
    "kimi-k2-1t-a32b", "nemotron-4-340b", "qwen2.5-32b", "recurrentgemma-9b",
    "smollm-135m", "xlstm-350m")] + [("smollm-135m", {"cim_linear": True}),
                                     ("qwen2.5-32b", {"kwn_ffn_k": 16})]


@pytest.mark.parametrize(
    "case", TRAIN_CASES,
    ids=lambda c: c[0] + "".join(f"-{k}" for k in c[1]))
def test_lm_loss_grads_and_train_step_on_card_equal_cpu(cuda, smoke, case):
    """Every reduced config (f32), and smollm in CIM mode and qwen2.5
    with KWN-FFN sparsity: ``lm.loss_fn``'s loss and every gradient leaf,
    then one ``build_train_step`` with two microbatches, on the card
    against the CPU at the CPU tests' tolerances, with no kernel launched
    (``chip_smoke.reduced_train_phase``, which raises on a miss)."""
    res = smoke.reduced_train_phase(*case, cuda)
    assert res["loss"] <= 1e-5 and res["grads"] <= res["grad_tol"]
    assert res["launches"] == 0


def test_lm_eval_step_launches_flash_once_a_layer(cuda):
    """``build_eval_step`` runs under ``no_grad``: the flash kernel once a
    layer, its loss within 1e-5 of ``loss_fn`` under autograd (the
    blockwise attention, which launches nothing), f32."""
    cfg = lm_base.reduced(get_config("smollm-135m"), n_layers=3)
    params = nn_module.materialize(lm.param_specs(cfg),
                                   torch.Generator(cuda).manual_seed(0),
                                   device=cuda)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 128))).to(cuda)
    before = kernels_flash.flash_attention_fwd.launches
    got = train_loop.build_eval_step(cfg)(params, {"tokens": toks})
    torch.cuda.synchronize()
    assert kernels_flash.flash_attention_fwd.launches == before + 3
    live = nn_module.tree_map(lambda p: p.detach().requires_grad_(),
                              params)
    want, _ = lm.loss_fn(live, {"tokens": toks}, cfg)
    torch.cuda.synchronize()
    assert kernels_flash.flash_attention_fwd.launches == before + 3
    torch.testing.assert_close(got["loss"], want.detach(), rtol=1e-5,
                               atol=1e-6)


def test_lm_train_steps_on_card_repeat_bit_for_bit(cuda, monkeypatch):
    """Under ``torch.use_deterministic_algorithms(True)`` (as
    ``launch.train`` runs) two runs of three train steps from the same
    state give the same parameters, moments and losses, bit for bit:
    the embedding's, the cross-entropy's and the GQA repeat's backward
    take their deterministic paths, and none raises."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = lm_base.reduced(get_config("smollm-135m"))
    params = nn_module.materialize(lm.param_specs(cfg),
                                   torch.Generator(cuda).manual_seed(1),
                                   device=cuda)
    ocfg = optim.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=20)
    step = train_loop.build_train_step(cfg, n_micro=2, opt_cfg=ocfg)
    rs = np.random.RandomState(2)
    batches = [train_loop.microbatch({"tokens": torch.from_numpy(
        rs.randint(0, cfg.vocab_size, (4, 64))).to(cuda)}, 2)
        for _ in range(3)]
    runs = []
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            p, st, losses = params, optim.adamw_init(params, ocfg), []
            for b in batches:
                p, st, m = step(p, st, b)
                losses.append(float(m["loss"]))
            runs.append((p, st, losses))
    finally:
        torch.use_deterministic_algorithms(False)
    (p0, s0, l0), (p1, s1, l1) = runs
    assert l0 == l1 and l0[-1] < l0[0]
    for a, b in zip(nn_module.leaves({"p": p0, "mu": s0.mu, "nu": s0.nu}),
                    nn_module.leaves({"p": p1, "mu": s1.mu, "nu": s1.nu})):
        assert torch.equal(a, b)


# --- tile plans: every candidate of a tuner cell, dense against gated ------

FORCED = dict(bm=32, bk=128, bn=128)     # no heuristic picks it at M = 64


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
@pytest.mark.parametrize("cell", autotune.CANONICAL_CELLS, ids=str)
def test_every_candidate_plan_equals_heuristic_and_plain(cuda, cell, noisy):
    """#1 through ``ops.fused_macro_seq`` under each of
    ``autotune.enumerate_candidates``' plans: MAC, membrane, spikes, mask
    and ADC steps equal to the heuristic plan's launch and to the plain
    version on the same card tensors; clean launches also dense."""
    x, msb, lsb, cb, scale, v = autotune._operands(cell, 3, device=cuda)
    args = (x, msb, lsb, cb.boundaries, cb.levels, scale, v)
    kw = dict(k=cell.k, drive_gain=autotune.DRIVE_GAIN, seed=9,
              step_offset=4)
    if noisy:
        kw.update(ima_noise=ima_lib.kernel_noise_params(
            ima_lib.IMANoiseModel(), cb), snl_amp=0.05)
    rows = torch.arange(cell.m, dtype=torch.int32, device=cuda)
    rc = torch.stack([torch.full_like(rows, 9), torch.full_like(rows, 4),
                      rows], -1)
    want = list(ref.fused_macro_seq_kwn_ref(
        *args, None, row_ctl=rc,
        **{k: a for k, a in kw.items() if k not in ("seed",
                                                     "step_offset")}))
    want[4] = want[4][..., 0]
    heur = autotune.heuristic_blocks(cell)
    cands = autotune.enumerate_candidates(cell)
    assert heur in cands and len(cands) > 1
    base = None
    for blocks in [heur] + [b for b in cands if b != heur]:
        for gate in (True, False) if not noisy else (True,):
            before = fused_macro.fused_macro_seq.launches
            got = ops.fused_macro_seq(*args, device=cuda, gate=gate,
                                      **dict(zip(("bm", "bk", "bn"),
                                                 blocks)), **kw)
            torch.cuda.synchronize()
            assert fused_macro.fused_macro_seq.launches == before + 1
            base = got if base is None else base
            for name, a, b, c in zip(("mac", "v_out", "spikes", "mask",
                                      "steps"), got, want, base):
                assert torch.equal(a, b), (blocks, gate, name)
                assert torch.equal(a, c), (blocks, gate, name)
    assert want[2].sum() > 0


@pytest.mark.parametrize("mode", ["kwn", "nld"])
def test_dense_and_forced_plan_equal_gated_heuristic(cuda, mode):
    """#1 and #2 at the serving round: dense (``gate=False``) and under
    bm = 32 / bk = 128 equal the gated heuristic launch bit for bit."""
    rs = np.random.RandomState(4)
    t, m, kdim, n = 8, 64, 512, 128
    x = torch.from_numpy(rs.choice([-1.0, 0.0, 1.0], p=[0.05, 0.9, 0.05],
                                   size=(t, m, kdim)).astype(np.float32))
    x[::2, :, :256] = 0.0
    v0 = torch.from_numpy(rs.uniform(-1, 1.2, (m, n)).astype(np.float32))
    if mode == "nld":
        fw, cfg = _nld_weights(kdim, n, 2, "relu")
        kw = dict(mode="nld", drive_gain=0.25,
                  ima_noise=macro_lib.fused_kernel_noise(fw, cfg))
        counter = fused_macro.fused_macro_seq_nld
    else:
        fw, cfg = _weights(rs, kdim, n)
        kw = dict(k=12, drive_gain=0.25, snl_amp=0.05,
                  ima_noise=macro_lib.fused_kernel_noise(fw, cfg))
        counter = fused_macro.fused_macro_seq
    args = (x, fw.msb, fw.lsb, fw.boundaries, fw.levels, fw.scale, v0,
            None, fw.w_dend)
    outs = []
    for plan, gate in (({}, True), ({}, False), (FORCED, True),
                       (FORCED, False)):
        before = counter.launches
        outs.append(ops.fused_macro_seq(*args, device=cuda, gate=gate,
                                        seed=3, step_offset=1, **plan, **kw))
        torch.cuda.synchronize()
        assert counter.launches == before + 1
    for got in outs[1:]:
        for a, b in zip(got, outs[0]):
            assert torch.equal(a, b)
    assert outs[0][2].sum() > 0


@pytest.mark.parametrize("remat", [False, True], ids=["residual", "remat"])
def test_bwd_kernel_bits_fixed_across_plans(cuda, remat):
    """#3 on operands padded to the heuristic plan and to bm = 32 / bk =
    128, gated and dense: the same dW and dv0 bits, and the plain
    version's."""
    res, _, _ = _train_operands((30, 64, 512, 128), True, cuda)
    outs = []
    for plan, gate in (({}, True), (FORCED, True), (FORCED, False)):
        args = ops.seq_grad_operands(*res, remat=remat, gate=gate, **plan)
        dw, dv0 = fused_macro_grad.fused_macro_seq_grad(*args, **GRAD_KW)
        dw_w, dv0_w = ref.fused_macro_seq_grad_ref(*args, **GRAD_KW)
        assert _ulps(dv0, dv0_w) == 0
        np.testing.assert_allclose(dw.cpu().numpy(), dw_w.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)
        outs.append((dw, dv0))
    for dw, dv0 in outs[1:]:
        assert torch.equal(dw, outs[0][0]) and torch.equal(dv0, outs[0][1])


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
def test_stack_plans_and_dense_equal_gated_heuristic(cuda, noisy):
    """#4 through ``ops.fused_macro_multi_seq`` on the heuristic plan,
    under bm = 32 with K tiles of 128 and 64, and dense: the same
    membranes, spikes, masks, ADC steps and spike counts; the dense
    launch reports every K tile occupied."""
    rs = np.random.RandomState(5)
    t, m, kdim, widths, ks = 30, 64, 512, (128, 128), (12, 12)
    stack, cfg = _stack(rs, kdim, widths)
    x = torch.from_numpy(rs.choice([-1.0, 0.0, 1.0], p=[0.05, 0.9, 0.05],
                                   size=(t, m, kdim)).astype(np.float32))
    vs = [torch.from_numpy(rs.uniform(-1, 1.2, (m, w)).astype(np.float32))
          for w in widths]
    nz = None if noisy else [prbs_lib.sequence_noise(m, t, w, 0.05, "cpu")
                             for w in widths]
    kw = dict(ks=ks, drive_gain=0.25, seeds=[5, 6], step_offset=2)
    if noisy:
        kw.update(ima_noise=macro_lib.fused_kernel_noise(stack[0], cfg),
                  snl_amp=0.05)
    layers = [(fw.msb, fw.lsb, fw.boundaries, fw.levels, fw.scale)
              for fw in stack]
    tiles = [(128, None), (64, None)]
    outs = []
    for plan, gate in (({}, True), (dict(bm=32, tile_shapes=tiles), True),
                       (dict(bm=32, tile_shapes=tiles), False)):
        before = fused_macro.fused_macro_multi_seq.launches
        outs.append(ops.fused_macro_multi_seq(x, layers, vs, nz, gate=gate,
                                              device=cuda, **plan, **kw))
        torch.cuda.synchronize()
        assert fused_macro.fused_macro_multi_seq.launches == before + 1
    want = ops.fused_macro_multi_seq(x, layers, vs, nz, device="cpu",
                                     bm=32, tile_shapes=tiles, **kw)
    for got in outs[1:] + [want]:
        for a, b in zip(got.v_outs, outs[0].v_outs):
            assert torch.equal(a.cpu(), b.cpu())
        for name in ("spikes", "mask"):
            assert torch.equal(getattr(got, name).cpu(),
                               getattr(outs[0], name).cpu()), name
        for name in ("steps", "spike_counts"):
            for a, b in zip(getattr(got, name), getattr(outs[0], name)):
                assert torch.equal(a.cpu(), b.cpu()), name
    for a, b in zip(outs[1].occupancy, want.occupancy):
        assert torch.equal(a.cpu(), b)
    assert [int(o.min()) for o in outs[2].occupancy] == [4, 2]
    assert [int(o.max()) for o in outs[2].occupancy] == [4, 2]
    assert outs[2].total_blocks == outs[1].total_blocks == t * 2 * 6


# --- the paper's experiments (experiments_torch) ---------------------------

@pytest.mark.parametrize("k", [1, 12, 48])
def test_use_snl_off_on_card_equals_cpu_composed(cuda, k):
    """``forward_silicon(use_snl=False, k=...)`` through #1 equals the
    CPU's composed path bit for bit (identity readout: the logits are the
    spike rates)."""
    cfg = snn.SNNConfig(n_in=512, n_hidden=128, n_classes=128, n_steps=20,
                        k=3)
    p = snn.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    p["w_out"] = torch.eye(128)
    rs = np.random.RandomState(8)
    ev = rs.choice([-1.0, 0.0, 1.0], p=[0.015, 0.97, 0.015],
                   size=(16, 20, 512)).astype(np.float32)
    before = fused_macro.fused_macro_seq.launches
    got = snn.forward_silicon(p, ev, cfg, device=cuda, k=k, use_snl=False)
    torch.cuda.synchronize()
    assert fused_macro.fused_macro_seq.launches == before + 1
    want = snn.forward_silicon(p, ev, cfg, device="cpu", fused=False, k=k,
                               use_snl=False)
    assert torch.equal(got[0].cpu(), want[0])
    for key in ("adc_steps", "lif_updates", "sops"):
        assert torch.equal(got[1][key].cpu(), want[1][key]), key
    assert float(got[1]["lif_updates"][0]) == k


def test_counter_transfer_error_on_card_equals_cpu(cuda):
    cb = ima_lib.nlq_codebook(5, -64, 64)
    params = ima_lib.kernel_noise_params(ima_lib.IMANoiseModel(), cb)
    rs = np.random.RandomState(3)
    for shape in ((4096,), (37, 200)):
        x = torch.from_numpy(rs.uniform(-70, 70, shape).astype(np.float32))
        for seed, step in ((0, 0), (7, 3), (2 ** 31 - 1, 1000)):
            got = ima_lib.ima_convert_noisy_ctr(x.to(cuda), cb.to(cuda),
                                                params, seed, step)
            want = ima_lib.ima_convert_noisy_ctr(x, cb, params, seed, step)
            assert torch.equal(got.cpu(), want), (shape, seed, step)
    got = ima_lib.measure_transfer_error_ctr(cb.to(cuda), seed=5)
    want = ima_lib.measure_transfer_error_ctr(cb, seed=5)
    for key in ("mean_lsb", "std_lsb"):
        assert abs(got[key] - want[key]) <= 1e-6, key
