"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``.  Nothing is
built at import time: ``library(name)`` builds on first use, into
``build/repro_torch/`` at the root of the checkout, under a file name that
carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.

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
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{tag[:16]}.so"


def _compile(name: str, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    BUILD_LOG[name] = proc.stdout
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built if needed)."""
    lib = _LOADED.get(name)
    if lib is None:
        out = _target(name)
        if not out.exists():
            _compile(name, out)
        lib = ctypes.CDLL(str(out))
        _LOADED[name] = lib
    return lib


def build_all() -> float:
    """Build and load every source; returns the wall seconds it took.

    One source so far, so they are built one after another; with more,
    start one ``nvcc`` per source at once.
    """
    t0 = time.perf_counter()
    for name in sources():
        library(name)
    return time.perf_counter() - t0
