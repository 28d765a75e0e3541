"""KV-cache quantization: the paper's NLQ idea (C2/C6) applied to serving.

Counterpart of ``repro.nn.kvq``.  Decode-time K/V activations are tightly
distributed, as the macro's MACs are, so low-bit codes with a per-vector
scale cut the memory-bound decode term by 2x (int8) or 4x (int4, two
nibbles to a byte).

Symmetric per-(position, head) scaling: q = round(x / s), s = max|x| / Q,
rounded half to even (``jnp.round`` and ``torch.round`` alike).  int4 packs
adjacent head-dim pairs into one uint8, ``(hi + 8) << 4 | (lo + 8)``.  The
divisions are tensor by tensor: on a CUDA tensor PyTorch computes tensor
by Python number as a product with the reciprocal, which is not the IEEE
quotient the reference takes.
"""

from __future__ import annotations

import torch

from repro_torch.core import f32math

_QMAX = {"int8": 127.0, "int4": 7.0}


def quantize(x: torch.Tensor, mode: str):
    """x (..., hd) -> (payload, scale (..., 1) f32)."""
    if mode not in _QMAX:
        raise ValueError(mode)
    qmax = _QMAX[mode]
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True).float()
    s = f32math.div(torch.clamp(scale, min=1e-8), qmax)
    q = torch.clamp(torch.round(x.float() / s), -qmax, qmax).to(torch.int8)
    if mode == "int8":
        return q, s
    hi = q[..., 1::2].to(torch.int32)
    lo = q[..., 0::2].to(torch.int32)
    return ((hi + 8) << 4 | (lo + 8)).to(torch.uint8), s


def dequantize(q: torch.Tensor, scale: torch.Tensor, mode: str,
               dtype=torch.bfloat16) -> torch.Tensor:
    if mode == "int8":
        return (q.float() * scale).to(dtype)
    if mode == "int4":
        lo = (q & 0xF).to(torch.int32) - 8
        hi = (q >> 4).to(torch.int32) - 8
        out = torch.stack([lo, hi], dim=-1).reshape(*q.shape[:-1],
                                                    q.shape[-1] * 2)
        return (out.float() * scale).to(dtype)
    raise ValueError(mode)


def storage_shape(hd: int, mode: str) -> int:
    return hd // 2 if mode == "int4" else hd


def storage_dtype(mode: str) -> torch.dtype:
    return torch.uint8 if mode == "int4" else torch.int8
