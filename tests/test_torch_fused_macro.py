"""The port's fused seq-KWN macro (plain version, CPU) against the JAX oracle.

``repro.kernels.ref.fused_macro_seq_ref`` runs on jax 0.9 (the Pallas
launches do not), so it is the reference: spikes, mask, ADC steps, MAC and
the final membrane must be equal bit for bit, clean and with the counter
noise, at several shapes including ragged ones that exercise batch, K and
column padding.  Also the ``row_ctl`` lane, the tile planner and the
activity map.  The CUDA kernel itself is held to this plain version on the
card (``chip_smoke.py`` and ``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ima as j_ima
from repro.core import macro as j_macro
from repro.kernels import fused_macro as j_fused
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch import convert
from repro_torch.core import ima as t_ima
from repro_torch.core import macro as t_macro
from repro_torch.kernels import fused_macro as t_fused
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

torch.set_num_threads(1)

# (T, M, K, N, k): engine-like, ragged rows/K, wide (column-padded) layer
SHAPES = [(6, 16, 64, 48, 6), (5, 13, 300, 40, 5), (4, 9, 96, 150, 12),
          (3, 3, 7, 20, 4)]
NOISE = j_ima.IMANoiseModel()


def _case(shape, seed=0):
    t, m, kdim, n, k = shape
    rs = np.random.RandomState(seed)
    w_int = rs.randint(-3, 4, size=(kdim, n)).astype(np.float32)
    scale = rs.uniform(0.01, 0.1, n).astype(np.float32)
    mcfg = j_macro.CIMMacroConfig(code_bits=5, mac_range=24.0,
                                  ima_noise=NOISE)
    fw = j_macro.pack_kwn_weights(jnp.asarray(w_int), jnp.asarray(scale),
                                  mcfg)
    x = rs.choice([-1.0, 0.0, 1.0], p=[0.1, 0.8, 0.1],
                  size=(t, m, kdim)).astype(np.float32)
    v0 = rs.uniform(-1.0, 1.2, (m, n)).astype(np.float32)
    nz = rs.choice([-0.05, 0.05], size=(t, m, n)).astype(np.float32)
    return fw, mcfg, x, v0, nz, k


def _oracle(fw, x, v0, nz, k, **kw):
    out = j_ref.fused_macro_seq_ref(jnp.asarray(x), fw.msb, fw.lsb,
                                    fw.boundaries, fw.levels, fw.scale,
                                    jnp.asarray(v0), nz, k=k,
                                    drive_gain=0.25, **kw)
    mac, v, spk, mask, steps = out
    return [np.asarray(a) for a in (mac, v, spk, mask, steps[..., 0])]


def _port(fw, x, v0, nz, k, **kw):
    tw = convert.fused_weights_from_jax(fw, device="cpu")
    out = t_ops.fused_macro_seq(
        torch.from_numpy(x), tw.msb, tw.lsb, tw.boundaries, tw.levels,
        tw.scale, torch.from_numpy(v0),
        None if nz is None else torch.from_numpy(nz), k=k, drive_gain=0.25,
        device="cpu", **kw)
    return [a.numpy() for a in out]


def _assert_all_equal(want, got):
    for name, a, b in zip(("mac", "v_out", "spikes", "mask", "steps"),
                          want, got):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_clean_equals_oracle(shape):
    fw, _, x, v0, nz, k = _case(shape)
    _assert_all_equal(_oracle(fw, x, v0, jnp.asarray(nz), k),
                      _port(fw, x, v0, nz, k))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_counter_noise_equals_oracle(shape):
    fw, mcfg, x, v0, _, k = _case(shape, seed=1)
    kn = j_macro.fused_kernel_noise(fw, mcfg)
    kw = dict(ima_noise=kn, snl_amp=0.05, seed=98765, step_offset=3)
    want = _oracle(fw, x, v0, None, k, **kw)
    got = _port(fw, x, v0, None, k, **kw)
    _assert_all_equal(want, got)
    assert want[3].sum() > 0                     # winners exist


def test_row_ctl_rows_replay_batch1_streams():
    """Each row with ``[seed, offset, 0]`` equals a batch-1 oracle run."""
    fw, mcfg, x, v0, _, k = _case((5, 6, 64, 32, 5), seed=2)
    kn = j_macro.fused_kernel_noise(fw, mcfg)
    seeds = [11, 22, 33, 44, 55, 66]
    offs = [0, 3, 8, 1, 13, 40]
    rc = np.stack([seeds, offs, [0] * 6], -1).astype(np.int32)
    got = _port(fw, x, v0, None, k, ima_noise=kn, snl_amp=0.05,
                row_ctl=torch.from_numpy(rc))
    for i in range(6):
        want = _oracle(fw, x[:, i:i + 1], v0[i:i + 1], None, k, ima_noise=kn,
                       snl_amp=0.05, seed=seeds[i], step_offset=offs[i])
        mac, v, spk, mask, steps = got
        _assert_all_equal(want, [mac[:, i:i + 1], v[i:i + 1],
                                 spk[:, i:i + 1], mask[:, i:i + 1],
                                 steps[:, i:i + 1]])


@pytest.mark.parametrize("m", [1, 7, 8, 37, 64, 130, 300])
def test_plan_tiles_matches_reference(m):
    for kdim in (7, 96, 128, 255, 256, 300, 512, 1000):
        for nc in (20, 128, 129, 200, 512):
            for t in (1, 8):
                want = j_fused.plan_tiles(m, kdim, nc, nc, t, use_cache=False)
                got = t_fused.plan_tiles(m, kdim, nc, nc, t)
                assert tuple(want) == tuple(got)
                assert want.activity_shape == got.activity_shape


def test_activity_map_matches_reference():
    rs = np.random.RandomState(3)
    for (t, m, kdim) in ((4, 16, 512), (3, 37, 300), (2, 130, 96)):
        plan = t_fused.plan_tiles(m, kdim, 128, 128, t)
        x = rs.choice([-1.0, 0.0, 1.0], p=[0.002, 0.996, 0.002],
                      size=(t, plan.m_pad, plan.k_pad)).astype(np.float32)
        x[::2, :, :plan.bk] = 0.0                # whole quiet blocks
        want = j_ops.fused_activity_map(jnp.asarray(x), plan)
        got = t_ops.fused_activity_map(torch.from_numpy(x), plan)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        assert 0 < got.sum() < got.numel()


def test_kwn_select_edge_cases():
    """Ties go to the lower column; padding (-1) never wins; fewer than K
    eligible columns run the full ramp."""
    codes = torch.tensor([[3, 5, 5, 1, -1, 5], [0, 0, -1, -1, -1, -1]],
                         dtype=torch.int32)
    mask, steps = t_ref.kwn_select(codes, 3, 8)
    assert mask.tolist() == [[0, 1, 1, 0, 0, 1], [1, 1, 0, 0, 0, 0]]
    assert steps[:, 0].tolist() == [8 - 1 - 5, 7]


def test_pack_and_noise_params_match_reference():
    rs = np.random.RandomState(4)
    w_int = rs.randint(-3, 4, size=(40, 24)).astype(np.float32)
    scale = rs.uniform(0.01, 0.1, 24).astype(np.float32)
    jcfg = j_macro.CIMMacroConfig(code_bits=5, mac_range=24.0,
                                  ima_noise=NOISE)
    tcfg = t_macro.CIMMacroConfig(code_bits=5, mac_range=24.0,
                                  ima_noise=t_ima.IMANoiseModel())
    jw = j_macro.pack_kwn_weights(jnp.asarray(w_int), jnp.asarray(scale), jcfg)
    tw = t_macro.pack_kwn_weights(torch.from_numpy(w_int),
                                  torch.from_numpy(scale), tcfg)
    for name in ("msb", "lsb", "scale", "boundaries", "levels"):
        np.testing.assert_array_equal(np.asarray(getattr(jw, name)),
                                      getattr(tw, name).numpy())
    assert tuple(j_macro.fused_kernel_noise(jw, jcfg)) == \
        tuple(t_macro.fused_kernel_noise(tw, tcfg))


def test_cpu_tensors_never_launch_the_kernel():
    fw, _, x, v0, nz, k = _case(SHAPES[0])
    before = t_fused.fused_macro_seq.launches
    _port(fw, x, v0, nz, k)
    assert t_fused.fused_macro_seq.launches == before

