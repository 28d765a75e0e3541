"""The kernels' launch path, ``kernels.fused_macro._run``, on the CPU.

Every wrapper of ``src/repro_torch/kernels`` launches through ``_run``: it
binds each (source, function) of ``csrc/`` once (``build.function``),
reads the current stream of the tensor's device, calls the C launcher and
raises if CUDA refused the launch.  The library and the CUDA calls are
stand-ins here; the card's tests (``test_torch_cuda.py``) launch for real.
"""

import ctypes

import pytest
import torch

from repro_torch.kernels import build, fused_macro, fused_macro_grad
from repro_torch.kernels import flash_attention as kernels_flash
from repro_torch.kernels import nlq_lut as kernels_nlq
from repro_torch.kernels import ternary_mac as kernels_tmac


class _Function:
    """A C launcher: records the parameter struct and the stream it was
    given, returns ``err``."""

    def __init__(self, err=0):
        self.err, self.streams, self.params = err, [], []
        self.argtypes = self.restype = None

    def __call__(self, params, stream):
        self.params.append(params._obj)
        self.streams.append(stream)
        return self.err


class _Library:
    def __init__(self, name, lookups, err):
        self.name, self.lookups, self.err = name, lookups, err

    def __getattr__(self, fn_name):
        self.lookups.append((self.name, fn_name))
        return _Function(self.err)


@pytest.fixture
def fake_cuda(monkeypatch):
    """``build.library`` and the CUDA device / stream queries as
    stand-ins; returns the list of (source, function) lookups."""
    lookups, state = [], {"err": 0, "device": 0}
    monkeypatch.setattr(build, "_BOUND", {})
    monkeypatch.setattr(build, "library",
                        lambda name: _Library(name, lookups, state["err"]))
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: state["device"])
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    return lookups, state


def test_run_binds_each_function_once(fake_cuda):
    lookups, _ = fake_cuda
    dev = torch.device("cuda", 0)
    for _ in range(3):
        fused_macro._run("ternary_mac", "tmac_launch",
                         kernels_tmac._Params(m=1), dev)
        fused_macro._run("nlq_lut", "nlq_launch", kernels_nlq._Params(), dev)
    assert lookups == [("ternary_mac", "tmac_launch"),
                       ("nlq_lut", "nlq_launch")]
    fn = build._BOUND["ternary_mac", "tmac_launch"]
    assert fn.argtypes == [ctypes.POINTER(kernels_tmac._Params),
                           ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
    assert fn.streams == [1000] * 3
    assert build.function("ternary_mac", "tmac_launch",
                          kernels_tmac._Params) is fn


def test_run_raises_when_cuda_refuses_the_launch(fake_cuda):
    _, state = fake_cuda
    state["err"] = 9                          # cudaErrorInvalidConfiguration
    with pytest.raises(RuntimeError, match="flash_attention launch failed: "
                                           "CUDA error 9"):
        fused_macro._run("flash_attention", "flash_launch",
                         kernels_flash._Params(), torch.device("cuda", 0))


def test_run_enters_the_device_only_when_it_is_not_current(fake_cuda,
                                                            monkeypatch):
    entered = []

    class _Guard:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            entered.append(self.dev)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "device", _Guard)
    params = kernels_tmac._Params(m=1)
    for dev in ("cuda:0", "cuda"):           # "cuda": the current device
        fused_macro._run("ternary_mac", "tmac_launch", params,
                         torch.device(dev))
    assert entered == []
    fused_macro._run("ternary_mac", "tmac_launch", params,
                     torch.device("cuda", 1))
    assert entered == [1]
    assert build._BOUND["ternary_mac", "tmac_launch"].streams == [
        1000, 1000, 1001]


@pytest.fixture
def allocations(monkeypatch):
    """``torch.empty`` that records {data pointer: shape} of what it
    allocates."""
    seen, empty = {}, torch.empty

    def recording_empty(*args, **kwargs):
        out = empty(*args, **kwargs)
        seen[out.data_ptr()] = tuple(out.shape)
        return out

    monkeypatch.setattr(torch, "empty", recording_empty)
    return seen


@pytest.mark.parametrize("train_trace", [False, True])
def test_seq_kwn_wrapper_hands_the_head_a_drive_scratch(fake_cuda,
                                                        allocations,
                                                        train_trace):
    """Kernel #1 is a head over every (step, row) pair and a LIF
    recurrence: its wrapper allocates the (T, M, N) drive between them
    and still counts one launch."""
    t, m, k_dim, n = 3, 8, 64, 5
    i8 = torch.int8
    before = fused_macro.fused_macro_seq.launches
    out = fused_macro._launch(
        torch.zeros((t, m, k_dim), dtype=i8),
        torch.zeros((k_dim, n), dtype=i8), torch.zeros((k_dim, n), dtype=i8),
        torch.zeros(3), torch.zeros(4), torch.ones(n), torch.zeros((m, n)),
        None, None, torch.zeros((m, 3), dtype=torch.int32), k=2, ratio=2.0,
        drive_gain=1.0, beta=0.9, v_th1=1.0, v_th2=0.6, v_reset=0.0,
        v_lim=8.0, use_snl=True, bm=8, bk=32, n_valid=n, ima_noise=None,
        snl_amp=0.0, mac_telemetry=True, train_trace=train_trace)
    assert fused_macro.fused_macro_seq.launches == before + 1
    assert len(out) == (6 if train_trace else 5)
    params = build._BOUND["fused_macro_seq_kwn", "fmsk_launch"].params[-1]
    assert allocations[params.drive] == (t, m, n)
    outputs = {params.mac, params.v_out, params.spikes, params.mask,
               params.steps, params.vtrace}
    assert params.drive not in outputs
    assert (params.vtrace is not None) == train_trace
    assert params.noise is None and params.activity is None
    assert params.snl is None                 # snl_amp 0: no SNL stream


@pytest.mark.parametrize("dense_noise", [False, True],
                         ids=["counter", "dense"])
def test_seq_kwn_wrapper_hands_the_lif_the_counter_snl_signs(
        fake_cuda, allocations, dense_noise):
    """The counter SNL stream is drawn in the head, over every (step, row)
    pair, into an int8 (T, M, N) scratch; a dense noise operand needs
    none."""
    t, m, k_dim, n = 2, 4, 32, 3
    i8 = torch.int8
    noise = torch.zeros((t, m, n)) if dense_noise else None
    fused_macro._launch(
        torch.zeros((t, m, k_dim), dtype=i8),
        torch.zeros((k_dim, n), dtype=i8), torch.zeros((k_dim, n), dtype=i8),
        torch.zeros(3), torch.zeros(4), torch.ones(n), torch.zeros((m, n)),
        noise, None, torch.zeros((m, 3), dtype=torch.int32), k=1,
        ratio=2.0, drive_gain=1.0, beta=0.9, v_th1=1.0, v_th2=0.6,
        v_reset=0.0, v_lim=8.0, use_snl=True, bm=4, bk=32, n_valid=n,
        ima_noise=None, snl_amp=0.05, mac_telemetry=False,
        train_trace=False)
    params = build._BOUND["fused_macro_seq_kwn", "fmsk_launch"].params[-1]
    if dense_noise:
        assert params.snl is None and params.noise == noise.data_ptr()
    else:
        assert allocations[params.snl] == (t, m, n)
        assert params.noise is None


@pytest.mark.parametrize("remat", [False, True], ids=["residual", "remat"])
def test_seq_grad_wrapper_allocates_the_kernels_scratch(fake_cuda,
                                                       allocations, remat):
    """Kernel #3's wrapper allocates ``g_mac`` with rows padded to 16
    bytes, the (DW_SLICES, K, N) partials of the contraction, and the
    (T, M, N) MAC only without a MAC residual."""
    t, m, k_dim, n = 3, 8, 64, 5
    f32 = torch.float32
    stack = torch.zeros((t, m, n), dtype=f32)
    planes = (torch.zeros((k_dim, n), dtype=torch.int8),) * 2
    before = fused_macro_grad.fused_macro_seq_grad.launches
    dw, dv0 = fused_macro_grad._launch(
        torch.zeros((t, m, k_dim), dtype=torch.int8), torch.ones(n), stack,
        torch.zeros((m, n)), stack, stack, None if remat else stack,
        *(planes if remat else (None, None)),
        torch.ones((t, 1), dtype=torch.int32), ratio=2.0, drive_gain=1.0,
        beta=0.9, v_th1=1.0, v_lim=8.0, kwn_relax=0.0, surrogate_beta=4.0,
        ste_lo=-24.5, ste_hi=24.5)
    assert fused_macro_grad.fused_macro_seq_grad.launches == before + 1
    params = build._BOUND["fused_macro_seq_kwn_bwd", "fmskb_launch"] \
        .params[-1]
    assert (params.ldg, params.n_slices) == (8, fused_macro_grad.DW_SLICES)
    assert allocations[params.g_mac] == (t, m, 8)
    assert allocations[params.part] == (fused_macro_grad.DW_SLICES, k_dim,
                                        n)
    assert (params.dw, params.dv0) == (dw.data_ptr(), dv0.data_ptr())
    if remat:
        assert allocations[params.mac_s] == (t, m, n)
        assert params.mac is None
    else:
        assert params.mac_s is None and params.mac == stack.data_ptr()


def test_nld_wrapper_hands_the_lif_an_activation_scratch(fake_cuda,
                                                        allocations):
    """Kernel #2 is a head over every (step, row) pair and column tile and
    a soma-and-LIF recurrence: its wrapper allocates the (T, M, J*N)
    activations between them, and the LIF writes the constant mask and
    ADC steps beside the spikes."""
    t, m, k_dim, n, nb = 3, 8, 64, 5, 2
    i8 = torch.int8
    before = fused_macro.fused_macro_seq_nld.launches
    mac, v_out, spikes, mask, steps = fused_macro._launch_nld(
        torch.zeros((t, m, k_dim), dtype=i8),
        torch.zeros((k_dim, nb * n), dtype=i8),
        torch.zeros((k_dim, nb * n), dtype=i8), torch.zeros(3),
        torch.zeros(4), torch.ones(nb * n), torch.ones((nb, n)),
        torch.zeros((m, n)), None, torch.zeros((m, 3), dtype=torch.int32),
        ratio=2.0, drive_gain=1.0, beta=0.9, v_th1=1.0, v_reset=0.0,
        v_lim=8.0, bm=8, bk=32, logical_n=n, ima_noise=None,
        mac_telemetry=True)
    assert fused_macro.fused_macro_seq_nld.launches == before + 1
    params = build._BOUND["fused_macro_seq_nld", "fmsn_launch"].params[-1]
    assert allocations[params.act] == (t, m, nb * n)
    outputs = {params.mac, params.v_out, params.spikes, params.mask,
               params.steps}
    assert params.act not in outputs and len(outputs) == 5
    assert (params.mask, params.steps) == (mask.data_ptr(),
                                           steps.data_ptr())
    assert tuple(mask.shape) == (t, m, n) and steps.dtype == torch.int32
    assert tuple(steps.shape) == (t, m, 1)
    assert (params.n, params.n_branches, params.logical_n) == (n, nb, n)
    with pytest.raises(ValueError, match="neurons"):
        fused_macro._launch_nld(
            torch.zeros((t, m, k_dim), dtype=i8),
            torch.zeros((k_dim, 0), dtype=i8),
            torch.zeros((k_dim, 0), dtype=i8), torch.zeros(3),
            torch.zeros(4), torch.ones(0), torch.ones((nb, 0)),
            torch.zeros((m, 0)), None, torch.zeros((m, 3), dtype=torch.int32),
            ratio=2.0, drive_gain=1.0, beta=0.9, v_th1=1.0, v_reset=0.0,
            v_lim=8.0, bm=8, bk=32, logical_n=0, ima_noise=None,
            mac_telemetry=True)


@pytest.mark.parametrize("widths", [(20, 200, 8), (200, 20, 8)], ids=str)
@pytest.mark.parametrize("dense_noise", [False, True],
                         ids=["counter", "dense"])
def test_stack_wrapper_hands_each_layer_its_scratch(fake_cuda, allocations,
                                                    widths, dense_noise):
    """Kernel #4 is 2L kernels, a head and a LIF a layer: its wrapper
    allocates one drive (and counter-SNL) scratch for every layer, one
    winner mask for the hidden layers (the last layer's is the output) and
    one int8 spike scratch, as wide as the widest hidden layer, that the
    next layer's head reads."""
    t, m, bm, k0 = 2, 8, 8, 64
    fan_ins = (k0,) + widths[:-1]
    specs = tuple(fused_macro.LayerSpec(a, b, 2, 32 if li == 0 else a)
                  for li, (a, b) in enumerate(zip(fan_ins, widths)))
    i8 = torch.int8
    planes = [(torch.zeros((s.k_dim, s.n), dtype=i8),
               torch.zeros((s.k_dim, s.n), dtype=i8), torch.zeros(3),
               torch.zeros(4), torch.ones(s.n)) for s in specs]
    noises = [torch.zeros((t, m, s.n)) for s in specs] if dense_noise \
        else None
    before = fused_macro.fused_macro_multi_seq.launches
    v_outs, spikes, mask, steps, counts, occ = fused_macro._launch_multi(
        torch.zeros((t, m, k0), dtype=i8), planes,
        [torch.zeros((m, s.n)) for s in specs], noises,
        torch.zeros((t, m // bm, 2), dtype=torch.int32),
        torch.zeros(4, dtype=torch.int32), specs=specs, ratio=2.0,
        drive_gain=1.0, beta=0.9, v_th1=1.0, v_th2=0.6, v_reset=0.0,
        v_lim=8.0, use_snl=True, bm=bm, ima_noise=None, snl_amp=0.05)
    assert fused_macro.fused_macro_multi_seq.launches == before + 1
    params = build._BOUND["fused_macro_multi_seq_kwn", "fmmk_launch"] \
        .params[-1]
    assert params.n_layers == 3
    assert allocations[params.drive] == (t, m, 200)
    if dense_noise:
        assert params.snl is None
    else:
        assert allocations[params.snl] == (t, m, 200)
    hidden, last = params.layers[:2], params.layers[2]
    assert hidden[0].mask == hidden[1].mask
    assert allocations[hidden[0].mask] == (t, m, 200)
    assert last.mask == mask.data_ptr() and tuple(mask.shape) == (t, m, 8)
    assert hidden[0].spk == hidden[1].spk and last.spk is None
    assert allocations[hidden[0].spk] == (t, m, 200)
    scratch = {params.drive, params.snl, hidden[0].mask, hidden[0].spk}
    outputs = {params.spikes, params.steps, params.counts,
               params.tile_bits, last.mask} | {lay.v_out for lay in
                                               params.layers[:3]}
    assert not scratch & outputs
    assert [v.data_ptr() for v in v_outs] == [lay.v_out for lay in
                                               params.layers[:3]]
    assert tuple(occ.shape) == (3, t, m // bm) and occ.dtype == torch.int32
    assert tuple(counts.shape) == (3, t, m) == tuple(steps.shape)


@pytest.mark.parametrize("shape, want", [
    ((64, 512, 128), (8, 64, 64, 4, 1)),      # the chain's step
    ((64, 128, 128), (4, 32, 32, 4, 1)),      # the stack chain's layer 2
    ((37, 300, 100), (8, 64, 64, 4, 1)),      # ragged K and N
    ((17, 0, 8), (1, 32, 32, 1, 1)),          # K = 0: one empty slice
    ((1, 48, 1024), (2, 32, 32, 32, 1)),
    ((130, 1000, 33), (8, 128, 128, 2, 3)),
    ((5, 4096, 64), (8, 512, 128, 2, 1)),     # four staged tiles a slice
], ids=str)
def test_ternary_mac_wrapper_hands_the_kernel_its_split(fake_cuda,
                                                       allocations, shape,
                                                       want):
    """Kernel #5 splits K over a cluster of CTAs that add their partials in
    shared memory: its wrapper hands it the split, the slice, the staged
    tile and the grid, and allocates the output and no scratch."""
    m, k_dim, n = shape
    i8 = torch.int8
    before = kernels_tmac.ternary_mac.launches
    out = kernels_tmac._launch(torch.zeros((m, k_dim), dtype=i8),
                               torch.zeros((k_dim, n), dtype=i8),
                               torch.zeros((k_dim, n), dtype=i8), 2.05)
    assert kernels_tmac.ternary_mac.launches == before + 1
    params = build._BOUND["ternary_mac", "tmac_launch"].params[-1]
    got = (params.k_split, params.k_chunk, params.k_tile, params.n_tiles,
           params.m_tiles)
    assert got == want
    assert (params.m, params.k_dim, params.n) == shape
    assert params.ratio == pytest.approx(2.05)
    assert allocations == {out.data_ptr(): (m, n)}
    assert params.out == out.data_ptr() and out.dtype == torch.float32
    # the kernel's own checks: whole slices of whole tiles cover K
    assert params.k_split in (1, 2, 4, 8)
    assert params.k_chunk % params.k_tile == 0
    assert params.k_tile in (32, 64, 128)
    assert params.k_split * params.k_chunk >= k_dim
    assert params.n_tiles * kernels_tmac.BN >= n
    assert params.m_tiles * kernels_tmac.BM >= m


def test_ternary_mac_plan_covers_every_k():
    """Every K up to 4096: a power-of-two split, under twice the number of
    32-row mma steps, of slices of whole tiles that cover K, each tile 32,
    64 or 128 rows (a swizzle's width); the slice is the shortest such
    that covers K."""
    for k_dim in range(0, 4097):
        p = kernels_tmac.plan(1, k_dim, 1)
        assert p.k_split in (1, 2, 4, 8) and p.k_chunk % p.k_tile == 0
        assert p.k_tile in (32, 64, 128)
        assert p.k_split * p.k_chunk >= k_dim
        assert p.k_split < 2 * max(1, -(-k_dim // 32))
        shorter = p.k_chunk // 2 if p.k_chunk <= 128 else p.k_chunk - 128
        assert shorter < 32 or p.k_split * shorter < k_dim
    top = kernels_tmac.plan(1, kernels_tmac.MAX_K, 1)
    assert top.k_split * top.k_chunk == kernels_tmac.MAX_K
    assert top.k_chunk <= 32767      # a slice's sums fit 16 bits
    with pytest.raises(ValueError, match="at most"):
        kernels_tmac.plan(1, kernels_tmac.MAX_K + 1, 1)
