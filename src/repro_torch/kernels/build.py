"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``; the device code
the kernels share is in ``csrc/*.cuh``.  Nothing is built at import time:
``library(name)`` builds on first use, into ``build/repro_torch/`` at the
root of the checkout, under a file name that carries a hash of the source,
the headers and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  ``build_all`` starts one ``nvcc`` per
source at once.

Flags: ``-O3`` without ``--use_fast_math`` (IEEE division and square
root), and ``-fmad=false``: the reference rounds after every multiply and
add except where it fuses them, and the kernels write those fused
multiply-adds out as ``fmaf``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}
_BOUND: dict[tuple[str, str], object] = {}   # (source, fn) -> bound function
BUILD_LOG: dict[str, str] = {}   # nvcc's output (ptxas register report)


def sources() -> list[str]:
    """Names (file stems) of every CUDA source of the port."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for hdr in sorted(CSRC.glob("*.cuh")):
        src += hdr.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{tag[:16]}.so"


def _start(name: str, out: Path):
    """Start ``nvcc`` for ``csrc/<name>.cu``; returns (process, temp path)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish(name: str, out: Path, proc, tmp: Path) -> None:
    """Wait for ``nvcc`` and move its library into place."""
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built if needed)."""
    lib = _LOADED.get(name)
    if lib is None:
        out = _target(name)
        if not out.exists():
            _finish(name, out, *_start(name, out))
        lib = ctypes.CDLL(str(out))
        _LOADED[name] = lib
    return lib


def function(name: str, fn_name: str, params_type):
    """``fn_name`` of ``csrc/<name>.cu``, an ``int fn(const Params*, void*
    stream)``, with its ``argtypes`` and ``restype`` set: bound once per
    (source, function) and cached, so a launch costs the host one dict
    lookup here."""
    fn = _BOUND.get((name, fn_name))
    if fn is None:
        fn = getattr(library(name), fn_name)
        fn.argtypes = [ctypes.POINTER(params_type), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BOUND[name, fn_name] = fn
    return fn


def build_all() -> float:
    """Build every source that is not built yet, one ``nvcc`` per source
    all started together, then load them; returns the wall seconds."""
    t0 = time.perf_counter()
    targets = {name: _target(name) for name in sources()}
    running = {name: _start(name, out) for name, out in targets.items()
               if name not in _LOADED and not out.exists()}
    try:
        for name, (proc, tmp) in running.items():
            _finish(name, targets[name], proc, tmp)
    finally:
        for proc, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name in targets:
        library(name)
    return time.perf_counter() - t0
