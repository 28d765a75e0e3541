"""The twin-cell ternary MAC kernel: the composed chain's first stage.

Counterpart of ``repro.kernels.ternary_mac`` (``ternary_mac``, the Pallas
kernel ``_ternary_mac_kernel``).  The hand-written CUDA kernel
``csrc/ternary_mac.cu`` replaces it: a dense product on Hopper's int8
tensor cores (``mma.sync`` s8 x s8 -> s32) of the events against both
planes, whose cost does not depend on how many events fired.  A CTA owns
64 rows, 32 columns and one slice of K; the slices of a column tile form a
thread-block cluster and add their exact int32 partials in distributed
shared memory, then ``fmaf(ratio, acc_msb, acc_lsb)`` once.  ``plan``
chooses the split, the slice and the grid; the kernel stages its operands
by TMA and masks ragged shapes itself, so the wrapper pads nothing and
allocates only the output.

A CUDA tensor launches the kernel, counted in ``ternary_mac.launches``; a
CPU tensor runs the plain version ``kernels.ref.ternary_mac_ref``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_macro import _operand, _run


BM, BN = 64, 32        # rows and columns of one CTA's output tile
MAX_SPLIT = 8          # CTAs of a cluster along K (the portable limit)
MAX_TILE = 128         # K rows of one staged tile
# a slice's sums travel as 16-bit halves of one word: at most 32767 rows
MAX_K = MAX_SPLIT * (32767 // MAX_TILE * MAX_TILE)


class _Params(ctypes.Structure):
    """Mirror of ``TmacParams`` in ``csrc/ternary_mac.cu``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "msb", "lsb", "out")] + [
        (name, ctypes.c_int) for name in ("m", "k_dim", "n")] + [
        ("ratio", ctypes.c_float)] + [
        (name, ctypes.c_int) for name in (
            "k_split", "k_chunk", "k_tile", "n_tiles", "m_tiles")]


class Plan(NamedTuple):
    """One launch's split of K and its grid ``(k_split, n_tiles,
    m_tiles)``; the ``k_split`` CTAs of a column tile form one cluster."""

    k_split: int   # CTAs along K, a power of two up to MAX_SPLIT
    k_chunk: int   # K rows of each CTA's slice, a multiple of k_tile
    k_tile: int    # K rows of one staged tile: 32, 64 or MAX_TILE
    n_tiles: int
    m_tiles: int


def plan(m: int, k_dim: int, n: int) -> Plan:
    """Enough CTAs at a small batch: K is cut into up to MAX_SPLIT slices
    of 32, 64 or 128 rows (64 each at K = 512), or of whole 128-row tiles
    past K = 1024, so that no staged tile reaches into the next slice and
    each tile's rows are a swizzle's width.  K = 0 is one empty slice: the
    kernel writes zeros.  K above MAX_K raises."""
    if k_dim > MAX_K:
        raise ValueError(f"the MAC kernel takes at most {MAX_K} inputs, "
                         f"got K = {k_dim}")
    steps = -(-k_dim // 32)
    split = 1
    while split < min(MAX_SPLIT, steps):
        split *= 2
    chunk = 32
    while chunk < 32 * -(-steps // split):
        chunk *= 2
    if chunk > MAX_TILE:
        chunk = MAX_TILE * -(-k_dim // (MAX_TILE * split))
    return Plan(split, chunk, min(chunk, MAX_TILE), -(-n // BN),
                -(-m // BM))


def ternary_mac(x: torch.Tensor, msb: torch.Tensor, lsb: torch.Tensor,
                ratio: float = 2.0) -> torch.Tensor:
    """x (M, K) int8 ternary, msb / lsb (K, N) int8 ternary -> (M, N) f32
    ``x @ (ratio * msb + lsb)``."""
    if x.device.type == "cpu":
        return ref.ternary_mac_ref(x, msb, lsb, ratio)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, msb, lsb, ratio)


def _launch(x, msb, lsb, ratio: float) -> torch.Tensor:
    """Check the operands, allocate the output (the kernel needs no
    scratch) and launch on ``x``'s device with ``plan``'s grid."""
    dev = x.device
    m, k_dim = x.shape
    n = msb.shape[1]
    i8 = torch.int8
    x = _operand(x, i8, (m, k_dim), dev)
    msb = _operand(msb, i8, (k_dim, n), dev)
    lsb = _operand(lsb, i8, (k_dim, n), dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    params = _Params(x=x.data_ptr(), msb=msb.data_ptr(), lsb=lsb.data_ptr(),
                     out=out.data_ptr(), m=m, k_dim=k_dim, n=n, ratio=ratio,
                     **plan(m, k_dim, n)._asdict())
    _run("ternary_mac", "tmac_launch", params, dev)
    ternary_mac.launches += 1
    return out


ternary_mac.launches = 0
