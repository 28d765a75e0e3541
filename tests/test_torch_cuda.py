"""Tests of the port that need the card (marker ``cuda``).

They import neither JAX nor ``repro`` (the GPU machine has no JAX), and
they skip with a reason where no CUDA device is present.  On the GPU
(``--noconftest``: ``tests/conftest.py`` imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import ima as ima_lib
from repro_torch.core import macro as macro_lib
from repro_torch.kernels import fused_macro, ops
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
