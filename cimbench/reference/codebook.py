"""The IMA's ramp codebooks and the Fig. 7 error model, for the
benchmark's reference.

A frozen copy of the parts of ``repro_torch.core.ima`` that the macro's
kernels take as operands: the companding NLQ codebook of KWN mode, the
activation codebooks of NLD mode (numpy in f32, in the order of
operations the kernels' tables were built in), and the Fig. 7 error
injected in code space.  The benchmark's reference imports nothing of
the program, so it builds these tables again itself.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cimbench.reference import f32math


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

    def to(self, device) -> "RampCodebook":
        """The codebook with its tables on ``device``."""
        return self._replace(levels=self.levels.to(device),
                             boundaries=self.boundaries.to(device))


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


def inject_code_error(ideal: torch.Tensor, x: torch.Tensor,
                      normal: torch.Tensor, params: IMAKernelNoise,
                      n_codes: int) -> torch.Tensor:
    """The Fig. 7 error in code space, given a standard-normal draw: the
    INL sinusoid over the ramp (peak ``inl_lsb``) plus ``offset_lsb +
    sigma_lsb * normal``, rounded half to even and clipped to the counter.

    The reference's arithmetic: the range denominator folded in f64 and
    cast once, ``2 pi u`` with the f32 constant, the C library's sinf, and
    ``ideal + inl_lsb * s`` and ``offset + sigma * normal`` as fused
    multiply-adds (XLA contracts both)."""
    f32 = torch.float32
    u = f32math.div(x.float() - torch.tensor(params.in_lo, dtype=f32),
                    params.in_hi - params.in_lo + 1e-9)
    s = f32math.sinf(f32math.TWO_PI_F32 * u)
    eps = f32math.fma(torch.tensor(params.sigma_lsb, dtype=f32),
                      normal.float(),
                      torch.tensor(params.offset_lsb, dtype=f32))
    pre = f32math.fma(torch.tensor(params.inl_lsb, dtype=f32), s,
                      ideal.float()) + eps
    return torch.clamp(torch.round(pre).to(torch.int32), 0, n_codes - 1)
