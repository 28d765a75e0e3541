"""Ternary inputs and twin-cell 3-bit weights (paper C1).

A twin 9T bit-cell stores a ternary value; two cells in banks with a 2:1
current ratio compose a signed 3-bit weight ``W = 2*W_msb + W_lsb`` in
[-3, 3].  Counterpart of ``repro.core.ternary`` (inference and the
weight fake-quantizer of quantization-aware training).
"""

from __future__ import annotations

import torch

from repro_torch.core import f32math

CURRENT_RATIO = 2.0  # I_MSB / I_LSB


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
