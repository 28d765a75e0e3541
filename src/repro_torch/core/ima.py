"""Reconfigurable nonlinear in-memory ADC (paper C2, Figs. 6/7).

The IMA builds a ramp on the read bit-lines; the step at which it crosses
the MAC value is the code.  A comparison against monotone boundaries is a
count of boundaries below the value.  Counterpart of ``repro.core.ima``
(inference, the straight-through quantizer of NLQ-aware training, and the
Fig. 7 silicon error model with its measurements).

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

from repro_torch.core import f32math


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


class _QuantizeSTE(torch.autograd.Function):
    """``ima_quantize`` forward; straight through inside the ramp's range
    (the levels' span +-0.5) backward."""

    @staticmethod
    def forward(ctx, x, levels, boundaries):
        ctx.save_for_backward(x, levels)
        code = torch.searchsorted(boundaries, x.contiguous())
        return levels[code]

    @staticmethod
    def backward(ctx, g):
        x, levels = ctx.saved_tensors
        lo, hi = levels[0], levels[-1]
        inside = (x >= torch.minimum(lo, hi) - 0.5) \
            & (x <= torch.maximum(lo, hi) + 0.5)
        return g * inside.to(g.dtype), None, None


def ima_quantize_ste(x: torch.Tensor, cb: RampCodebook) -> torch.Tensor:
    """Differentiable fake-quantization through the IMA (NLQ-aware
    training, Fig. 6c): the value of ``ima_quantize``, a straight-through
    gradient inside the ramp's range."""
    return _QuantizeSTE.apply(x, cb.levels.to(x.device),
                              cb.boundaries.to(x.device))


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


def lsb_size(cb: RampCodebook) -> float:
    """One code step of the ramp's input range."""
    return (cb.in_hi - cb.in_lo) / (cb.n_codes - 1)


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


def _noisy_codes(x: torch.Tensor, cb: RampCodebook, normal: torch.Tensor,
                 noise: IMANoiseModel) -> torch.Tensor:
    """``ima_convert_noisy`` on a given standard-normal draw ``normal``
    (shaped like ``x``)."""
    return inject_code_error(ima_convert(x, cb), x, normal,
                             kernel_noise_params(noise, cb), cb.n_codes)


def ima_convert_noisy(x: torch.Tensor, cb: RampCodebook,
                      generator: torch.Generator,
                      noise: IMANoiseModel = IMANoiseModel()
                      ) -> torch.Tensor:
    """Conversion with the comparator offset, thermal noise and INL of
    Fig. 7, in code LSBs; the normal draw comes from ``generator`` (the
    reference's comes from a JAX key: the same law, other numbers)."""
    normal = torch.randn(x.shape, generator=generator,
                         device=generator.device).to(x.device)
    return _noisy_codes(x, cb, normal, noise)


def _sweep(cb: RampCodebook, n_points: int, device) -> torch.Tensor:
    """The measurement's input sweep: ``jnp.linspace`` over the range."""
    return torch.from_numpy(_linspace_f32(cb.in_lo, cb.in_hi,
                                          n_points)).to(device)


def measure_transfer_error(cb: RampCodebook, generator: torch.Generator,
                           noise: IMANoiseModel = IMANoiseModel(),
                           n_points: int = 4096) -> dict:
    """Monte-Carlo of the Fig. 7a measurement: sweep the input range,
    convert with noise, compare with the ideal code; mean and sigma of the
    error in LSB (the paper: 0.41 and 1.34)."""
    xs = _sweep(cb, n_points, generator.device)
    err = (ima_convert_noisy(xs, cb, generator, noise)
           - ima_convert(xs, cb)).float()
    return {"mean_lsb": float(err.mean()),
            "std_lsb": float(err.std(correction=0))}


def measure_inl(cb: RampCodebook, f, n_points: int = 4096,
                generator: torch.Generator | None = None,
                noise: IMANoiseModel | None = None) -> float:
    """Average INL of the NL-activation ramp against the ideal curve
    ``f`` (a numpy f32 function, as ``DENDRITE_ACTIVATIONS``), in LSB of
    the output range (Fig. 7b).  With ``noise`` and ``generator`` the
    silicon's systematic error (the INL sinusoid, no offset, no thermal
    noise) is included: the paper's 0.91 LSB."""
    dev = cb.levels.device if generator is None else generator.device
    xs = _sweep(cb, n_points, dev)
    if noise is not None and generator is not None:
        codes = ima_convert_noisy(
            xs, cb, generator,
            IMANoiseModel(0.0, noise.sigma_lsb * 0.0, noise.inl_lsb))
        y_hat = ima_reconstruct(codes, cb)
    else:
        y_hat = ima_quantize(xs, cb)
    y = torch.from_numpy(np.asarray(f(xs.cpu().numpy()), np.float32)
                         ).to(dev)
    levels = cb.levels.to(dev)
    out_lsb = f32math.div(levels.max() - levels.min(), cb.n_codes - 1)
    inl = f32math.div((y_hat - y).abs(), torch.clamp(out_lsb, min=1e-9))
    return float(inl.mean())
