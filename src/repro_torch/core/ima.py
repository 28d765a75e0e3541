"""Reconfigurable nonlinear in-memory ADC (paper C2, Figs. 6/7).

The IMA builds a ramp on the read bit-lines; the step at which it crosses
the MAC value is the code.  A comparison against monotone boundaries is a
count of boundaries below the value.  Counterpart of ``repro.core.ima``
(inference subset).

The codebooks are built with numpy in f32 so that they equal the
reference's ``jnp.linspace``-based codebooks bit for bit: XLA computes
``linspace`` as ``start * (1 - i * c) + i * (stop * c)`` with ``c`` the f32
reciprocal of ``num - 1`` and a fused multiply-add for the sum (the second
sample fuses the other product), and the companding power is taken in
f64 and rounded once.  Pinned for 2..64 codes by the CPU tests.

The NLD activation codebooks (``activation_codebook``) sample the
dendrite nonlinearities of ``DENDRITE_ACTIVATIONS`` on the same
``linspace``.  They are numpy f32 functions written in the reference's
operation order; ``sigmoid4`` is ``4 / (1 + exp(-x))`` with XLA's f32
``exp`` (the Cephes polynomial with fused multiply-adds, ``_expf``), which
is not correctly rounded and differs from ``np.exp`` by one ULP on some
inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RampCodebook(NamedTuple):
    """levels (n_codes,) LUT values, boundaries (n_codes - 1,) thresholds,
    and the full-scale analog input range."""

    levels: torch.Tensor
    boundaries: torch.Tensor
    in_lo: float
    in_hi: float

    @property
    def n_codes(self) -> int:
        return int(self.levels.shape[0])


def _fma32(a, b, c) -> np.ndarray:
    """f32 fused multiply-add in numpy (f64 product + repaired rounding)."""
    a, b, c = (np.asarray(t, np.float32).astype(np.float64) for t in (a, b, c))
    p = a * b
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    with np.errstate(invalid="ignore"):
        nudged = np.nextafter(s, np.where(err > 0, np.inf, -np.inf))
    return np.where(err != 0, nudged, s).astype(np.float32)


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    f32 = np.float32
    if num == 1:
        return np.array([start], f32)
    div = num - 1
    c = f32(1.0 / div)
    it = np.arange(div, dtype=f32)
    a, b = f32(start), f32(stop)
    sc = f32(b * c)
    one_minus = (f32(1.0) - (it * c).astype(f32)).astype(f32)
    out = _fma32(it, sc, (a * one_minus).astype(f32))
    if div > 1:
        out[1] = _fma32(a, one_minus[1], sc)
    return np.concatenate([out, [b]]).astype(f32)


def _expf(x: np.ndarray) -> np.ndarray:
    """f32 ``exp`` as XLA computes it on the CPU: the Cephes range
    reduction and polynomial, every multiply-add fused, and subnormal
    results flushed to zero."""
    f32 = np.float32
    x = np.clip(np.asarray(x, f32), f32(-104.0), f32(88.8))
    n = np.floor(_fma32(x, f32(1.44269504088896341), f32(0.5)))
    n = np.clip(n, f32(-127.0), f32(127.0)).astype(f32)
    a = _fma32(f32(-0.693359375), n, x)
    a = _fma32(f32(2.12194440e-4), n, a)
    z = _fma32(a, f32(1.9875691500e-4), f32(1.3981999507e-3))
    for c in (8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1,
              5.0000001201e-1):
        z = _fma32(z, a, f32(c))
    z = _fma32(z, (a * a).astype(f32), a)
    z = (f32(1.0) + z).astype(f32)
    two_n = np.ldexp(f32(1.0), n.astype(np.int32)).astype(f32)
    out = (z * two_n).astype(f32)
    return np.where(out < np.finfo(f32).tiny, f32(0.0), out)


def _codebook(levels: np.ndarray, in_lo: float, in_hi: float) -> RampCodebook:
    f32 = np.float32
    bounds = (f32(0.5) * (levels[1:] + levels[:-1]).astype(f32)).astype(f32)
    return RampCodebook(torch.from_numpy(levels.astype(f32)),
                        torch.from_numpy(bounds), float(in_lo), float(in_hi))


def linear_codebook(code_bits: int, in_lo: float, in_hi: float
                    ) -> RampCodebook:
    """Uniform ramp: the IMA's default linear-ADC configuration."""
    return _codebook(_linspace_f32(in_lo, in_hi, 2 ** code_bits),
                     in_lo, in_hi)


def nlq_codebook(code_bits: int, in_lo: float, in_hi: float,
                 gamma: float = 2.0) -> RampCodebook:
    """Nonlinear (companding) codebook, dense near zero (Fig. 6b)."""
    f32 = np.float32
    u = _linspace_f32(-1.0, 1.0, 2 ** code_bits)
    mag = np.power(np.abs(u).astype(np.float64), gamma).astype(f32)
    comp = (np.sign(u) * mag).astype(f32)
    mid, half = (in_hi + in_lo) / 2.0, (in_hi - in_lo) / 2.0
    levels = (f32(mid) + (f32(half) * comp).astype(f32)).astype(f32)
    return _codebook(levels, in_lo, in_hi)


def quadratic(x: np.ndarray) -> np.ndarray:
    """y = 0.5 x^2: the measured Fig. 7b activation."""
    f32 = np.float32
    return ((f32(0.5) * x).astype(f32) * x).astype(f32)


def relu(x: np.ndarray) -> np.ndarray:
    return np.maximum(x, np.float32(0.0))


def sigmoid4(x: np.ndarray) -> np.ndarray:
    """Saturating dendritic nonlinearity, ``4 * sigmoid(x)``."""
    f32 = np.float32
    sig = (f32(1.0) / (f32(1.0) + _expf(-x)).astype(f32)).astype(f32)
    return (f32(4.0) * sig).astype(f32)


DENDRITE_ACTIVATIONS = {
    "quadratic": quadratic,
    "relu": relu,
    "sigmoid4": sigmoid4,
}


def activation_codebook(code_bits: int, f, in_lo: float,
                        in_hi: float) -> RampCodebook:
    """NL-activation ramp (Fig. 6a, NLD): the ramp decides on uniform input
    steps and the LUT holds ``f`` at those steps, so the counter output
    approximates ``f(x)``.  ``f`` maps an f32 numpy array to f32."""
    f32 = np.float32
    xs = _linspace_f32(in_lo, in_hi, 2 ** code_bits)
    bounds = (f32(0.5) * (xs[1:] + xs[:-1]).astype(f32)).astype(f32)
    return RampCodebook(torch.from_numpy(np.asarray(f(xs), f32)),
                        torch.from_numpy(bounds), float(in_lo), float(in_hi))


def ima_convert(x: torch.Tensor, cb: RampCodebook) -> torch.Tensor:
    """Ramp conversion: the count of boundaries strictly below ``x``."""
    bounds = cb.boundaries.to(x.device)
    return torch.searchsorted(bounds, x.float().contiguous(),
                              right=False).to(torch.int32)


def ima_reconstruct(code: torch.Tensor, cb: RampCodebook) -> torch.Tensor:
    """LUT map-back of codes (clipped to the counter range)."""
    levels = cb.levels.to(code.device)
    return levels[torch.clamp(code.long(), 0, cb.n_codes - 1)]


def ima_quantize(x: torch.Tensor, cb: RampCodebook) -> torch.Tensor:
    """convert + reconstruct: the value the digital LIF receives."""
    return ima_reconstruct(ima_convert(x, cb), cb)


class IMANoiseModel(NamedTuple):
    """Injected non-idealities in code LSBs, calibrated so the measured
    statistics reproduce Fig. 7 (mean 0.41 LSB, sigma 1.34 LSB)."""

    offset_lsb: float = 0.45
    sigma_lsb: float = 1.35
    inl_lsb: float = 0.56


class IMAKernelNoise(NamedTuple):
    """``IMANoiseModel`` bound to a codebook's input range (kernel form)."""

    offset_lsb: float
    sigma_lsb: float
    inl_lsb: float
    in_lo: float
    in_hi: float


def kernel_noise_params(noise: IMANoiseModel,
                        cb: RampCodebook) -> IMAKernelNoise:
    """Bind an ``IMANoiseModel`` to a codebook's input range."""
    return IMAKernelNoise(
        offset_lsb=float(noise.offset_lsb), sigma_lsb=float(noise.sigma_lsb),
        inl_lsb=float(noise.inl_lsb), in_lo=float(cb.in_lo),
        in_hi=float(cb.in_hi))
