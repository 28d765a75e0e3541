"""Ternary inputs and twin-cell 3-bit weights (paper C1).

A twin 9T bit-cell stores a ternary value; two cells in banks with a 2:1
current ratio compose a signed 3-bit weight ``W = 2*W_msb + W_lsb`` in
[-3, 3].  Counterpart of ``repro.core.ternary`` (inference, the
current-ratio variation model, the weight fake-quantizer of
quantization-aware training, the hard ternarizer with its clipped
straight-through gradient, and Fig. 3d's weight-implementation cost).
"""

from __future__ import annotations

import torch

from repro_torch.core import f32math

CURRENT_RATIO = 2.0  # I_MSB / I_LSB


def ternary_quantize(x: torch.Tensor, scale=1.0,
                     threshold: float = 0.5) -> torch.Tensor:
    """Hard ternarization: ``sign(x / scale)`` where ``|x / scale| >
    threshold`` (strictly), else 0; ``scale`` a number or a tensor that
    broadcasts against ``x`` (a per-channel scale)."""
    xs = f32math.div(x, scale)
    return torch.where(torch.abs(xs) > threshold, torch.sign(xs),
                       torch.zeros_like(xs))


class _TernarySTE(torch.autograd.Function):
    """``ternary_quantize(x, scale)`` forward; backward the clipped
    straight-through gradient ``g * (|x / scale| <= 1.5)`` for ``x`` and
    a zero gradient for a tensor ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(x)
        ctx.scale = scale.detach() if isinstance(scale, torch.Tensor) \
            else scale
        return ternary_quantize(x, scale)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        scale = ctx.scale
        mask = (torch.abs(f32math.div(x, scale)) <= 1.5).to(g.dtype)
        return g * mask, (torch.zeros_like(scale)
                          if isinstance(scale, torch.Tensor) else None)


def ternary_ste(x: torch.Tensor, scale) -> torch.Tensor:
    """Hard ternarization (threshold 0.5) with the clipped
    straight-through gradient: it passes inside the representable range
    ``|x / scale| <= 1.5`` and nothing reaches ``scale``."""
    return _TernarySTE.apply(x, scale)


def ternary_input_encode(spikes: torch.Tensor) -> torch.Tensor:
    """Clip event values onto the ternary alphabet {-1, 0, +1}."""
    return torch.clamp(torch.round(spikes), -1, 1)


def weight_decompose(w_int: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split integer weights in [-3, 3] into (msb, lsb) ternary planes.

    ``msb = round(w / 2)`` (half to even) and ``lsb = w - 2 * msb``, both
    in {-1, 0, 1}.
    """
    w = torch.round(torch.clamp(w_int, -3, 3))
    msb = torch.clamp(torch.round(w / 2.0), -1.0, 1.0)
    return msb, w - 2.0 * msb


def weight_compose(msb: torch.Tensor, lsb: torch.Tensor,
                   ratio: float = CURRENT_RATIO) -> torch.Tensor:
    """The effective weight the analog array realizes."""
    return ratio * msb + lsb


def sample_current_ratio(generator: torch.Generator, shape=(),
                         sigma: float = 0.02,
                         nominal: float = CURRENT_RATIO) -> torch.Tensor:
    """Monte-Carlo sample of I_MSB / I_LSB: a lognormal spread of
    ``sigma`` about ``nominal`` (Fig. 3c), on the generator's device."""
    z = torch.randn(tuple(shape), generator=generator,
                    device=generator.device)
    return nominal * torch.exp(sigma * z)


def effective_weights(msb: torch.Tensor, lsb: torch.Tensor,
                      generator: torch.Generator | None = None,
                      sigma: float = 0.0) -> torch.Tensor:
    """Weights as the macro realizes them, with a per-column current
    ratio drawn from ``generator`` when ``sigma > 0``."""
    if generator is None or sigma == 0.0:
        return weight_compose(msb, lsb)
    ratio = sample_current_ratio(generator, msb.shape[-1:], sigma=sigma)
    return weight_compose(msb, lsb, ratio=ratio.to(msb.device))


def quantize_weights_3bit(w: torch.Tensor, per_channel: bool = True
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric quantization of float weights onto the [-3, 3] grid.

    Returns ``(w_int, scale)`` with ``w ~= w_int * scale``; ``per_channel``
    scales along the last axis (macro columns).  Rounding is half to even.
    """
    if per_channel:
        dims = tuple(range(w.dim() - 1))
        scale = f32math.div(torch.amax(torch.abs(w), dim=dims, keepdim=True),
                            3.0)
    else:
        scale = f32math.div(torch.amax(torch.abs(w)), 3.0)
    scale = torch.clamp(scale, min=1e-8)
    return torch.round(torch.clamp(w / scale, -3, 3)), scale


def pack_ternary(x: torch.Tensor) -> torch.Tensor:
    """Ternary {-1, 0, 1} values as int8."""
    return torch.round(x).to(torch.int8)


def unpack_ternary(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``pack_ternary``: the int8 values as ``dtype``."""
    return x.to(dtype)


def weight_implementation_cost(bits: int, scheme: str
                               ) -> tuple[float, float]:
    """(latency_cycles, bitcell_count) per weight for Fig. 3d's comparison.

    - "twin" (ours): B = bits-1 ratio-2 ternary banks give a +-(2^B - 1)
      range (B=2 is the 3-bit silicon): latency B, B twin cells.
    - "pwm": one differential cell, pulse width 2^(bits-1) steps.
    - "mcl": 2^bits - 1 unary cells, latency 1.

    At 5 bits: latency 16/4 = 4x against PWM and cells 31/4 = 7.75 ~ 7.8x
    against MCL, the paper's Fig. 3d claims.
    """
    if scheme == "twin":
        n_banks = max(1, bits - 1)
        return float(n_banks), float(n_banks)
    if scheme == "pwm":
        return float(2 ** (bits - 1)), 1.0
    if scheme == "mcl":
        return 1.0, float(2 ** bits - 1)
    raise ValueError(f"unknown scheme {scheme!r}")


class _QuantizeSTE(torch.autograd.Function):
    """``w_int * scale`` forward; straight through inside the grid's clip
    range (``|w / scale| <= 3.5``) backward."""

    @staticmethod
    def forward(ctx, w):
        ctx.save_for_backward(w)
        w_int, scale = quantize_weights_3bit(w)
        return w_int * scale

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        dims = tuple(range(w.dim() - 1))
        scale = torch.clamp(f32math.div(
            torch.amax(torch.abs(w), dim=dims, keepdim=True), 3.0), min=1e-8)
        return g * (torch.abs(f32math.div(w, scale)) <= 3.5).to(g.dtype)


def quantize_weights_ste(w: torch.Tensor) -> torch.Tensor:
    """Fake-quantize weights onto the twin-cell grid (per-column scale),
    with a straight-through gradient inside the clip range."""
    return _QuantizeSTE.apply(w)
