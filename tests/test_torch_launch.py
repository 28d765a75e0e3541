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

from repro_torch.kernels import build, fused_macro
from repro_torch.kernels import flash_attention as kernels_flash
from repro_torch.kernels import nlq_lut as kernels_nlq
from repro_torch.kernels import ternary_mac as kernels_tmac


class _Function:
    """A C launcher: records the stream it was given, returns ``err``."""

    def __init__(self, err=0):
        self.err, self.streams = err, []
        self.argtypes = self.restype = None

    def __call__(self, params, stream):
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
