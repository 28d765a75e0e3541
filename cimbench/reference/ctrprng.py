"""Counter-based PRNG for the Fig. 7 IMA error and the SNL sign noise.

Threefry-2x32-20 keyed on ``(seed, tag ^ step)`` with the counter
``(row, column)``: every draw is a pure function of those words, so the
stream does not depend on tiling, padding or batching.  A frozen copy
of ``repro_torch.core.ctrprng`` for the benchmark's reference.  PyTorch
has no full uint32 arithmetic, so the words live in int64 tensors masked
to 32 bits, and the elementary functions come from ``f32math``.  The CUDA
kernel carries the same operations on ``uint32_t``.
"""

from __future__ import annotations

import torch

from cimbench.reference import codebook, f32math

TAG_IMA = 0x494D4101   # IMA conversion error (Fig. 7a/b)
TAG_SNL = 0x534E4C01   # SNL probabilistic-firing sign noise (Eq. 1 n(t))

_PARITY = 0x1BD11BDA
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_M32 = 0xFFFFFFFF


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32-20 on broadcastable words; returns two int64 tensors
    holding uint32 values."""
    k0, k1 = _u32(k0), _u32(k1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (_u32(c0) + k0) & _M32
    x1 = (_u32(c1) + k1) & _M32
    for i in range(5):
        for r in (_ROT_A if i % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _unit_open(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> f32 uniform on (0, 1) from the top 24 bits."""
    return ((bits >> 8).float() + 0.5) * (2.0 ** -24)


def _key1(step, tag: int) -> torch.Tensor:
    return _u32(tag) ^ _u32(step)


def counter_normal(seed, step, rows, cols, tag: int) -> torch.Tensor:
    """One standard-normal f32 draw per (row, col) (Box-Muller)."""
    b0, b1 = threefry2x32(seed, _key1(step, tag), rows, cols)
    r = f32math.sqrtf(-2.0 * f32math.logf(_unit_open(b0)))
    theta = f32math.TWO_PI_F32 * _unit_open(b1)
    return r * f32math.cosf(theta)


def counter_sign(seed, step, rows, cols, tag: int) -> torch.Tensor:
    """+-1.0 f32 per element: the low bit of the first Threefry word."""
    b0, _ = threefry2x32(seed, _key1(step, tag), rows, cols)
    return (b0 & 1).float() * 2.0 - 1.0


def noisy_ima_codes(ideal_codes: torch.Tensor, x: torch.Tensor, rows, cols,
                    seed, step, params, n_codes: int) -> torch.Tensor:
    """Fig. 7 error injection in code space (``ima.inject_code_error``)
    with the counter stream's normal draw at ``(seed, step, row, col)``.

    ``params`` carries ``offset_lsb / sigma_lsb / inl_lsb / in_lo / in_hi``
    (``ima.IMAKernelNoise``).
    """
    g = counter_normal(seed, step, rows, cols, TAG_IMA)
    return codebook.inject_code_error(ideal_codes, x, g, params, n_codes)
