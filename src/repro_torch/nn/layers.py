"""Shared layers: linear / embedding / norm / rope, and the CIM-mode
linear (paper C1/C2 applied to LM projections).

Counterpart of ``repro.nn.layers``, with its dtype flow: ``linear`` casts
the weight to the activation's dtype, ``rmsnorm`` and ``rope`` compute in
f32 and cast back, ``cim_linear`` computes in f32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import f32math
from repro_torch.core import ima as ima_lib
from repro_torch.core import ternary as ternary_lib
from repro_torch.nn.module import ParamSpec


# --- param-spec builders ----------------------------------------------------

def linear_spec(d_in: int, d_out: int, in_axis: str | None,
                out_axis: str | None, bias: bool = False,
                dtype=torch.float32) -> dict:
    s = {"w": ParamSpec((d_in, d_out), (in_axis, out_axis), dtype)}
    if bias:
        s["b"] = ParamSpec((d_out,), (out_axis,), dtype, init="zeros")
    return s


def embed_spec(vocab: int, d: int, dtype=torch.float32) -> dict:
    return {"table": ParamSpec((vocab, d), ("vocab", "embed"), dtype,
                               init="embed")}


def norm_spec(d: int, dtype=torch.float32) -> dict:
    return {"scale": ParamSpec((d,), (None,), dtype, init="zeros")}


# --- forward ops ------------------------------------------------------------

def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def cim_linear(p: dict, x: torch.Tensor, code_bits: int = 5,
               nlq_gamma: float = 2.0) -> torch.Tensor:
    """CIM-mode linear: ternary twin-cell weights (QAT STE) and NLQ
    activations.

    Weights fake-quantise onto the [-3, 3] twin-cell grid (per-column
    scale); the f32 product goes through the NLQ ramp, its codebook sized
    to the largest magnitude of the whole product (one scale for every row
    of the batch, as the reference has it).
    """
    w_q = ternary_lib.quantize_weights_ste(p["w"].float())
    y = x.float() @ w_q
    if "b" in p:
        y = y + p["b"].float()
    scale = torch.clamp(torch.amax(torch.abs(y.detach())), min=1e-3)
    cb = _nlq_codebook_on(code_bits, nlq_gamma, y.device)
    y = ima_lib.ima_quantize_ste(f32math.div(y, scale), cb) * scale
    return y.to(x.dtype)


# Constants built on the host once per device: a copy from pageable host
# memory waits for the device's stream, so building them per call would
# stall the host at every layer.

@functools.lru_cache(maxsize=None)
def _nlq_codebook_on(code_bits: int, gamma: float,
                     device: torch.device) -> ima_lib.RampCodebook:
    cb = ima_lib.nlq_codebook(code_bits, -1.0, 1.0, gamma)
    return cb._replace(levels=cb.levels.to(device),
                       boundaries=cb.boundaries.to(device))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(half: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    return torch.from_numpy(rope_freqs(half, theta)).to(device)


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6,
            plus_one: bool = True) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    scale = p["scale"].float()
    scale = 1.0 + scale if plus_one else scale
    return (xf * scale).to(dt)


def embed(p: dict, ids: torch.Tensor,
          scale_by_dim: bool = False) -> torch.Tensor:
    table = p["table"]
    y = table[ids]
    if scale_by_dim:
        y = y * torch.sqrt(torch.tensor(float(table.shape[-1]),
                                        dtype=y.dtype, device=y.device))
    return y


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["table"].T.to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# --- rotary position embedding ----------------------------------------------

def rope_freqs(half: int, theta: float) -> np.ndarray:
    """``theta ** (-arange(half) / half)`` in f32, as the reference's
    ``jnp`` power rounds it: the f32 exponent, raised in f64, rounded
    once (``torch.pow`` in f32 differs in the last bit of a few)."""
    e = (-np.arange(half, dtype=np.float32) / np.float32(half)
         ).astype(np.float32)
    return (np.float64(theta) ** e.astype(np.float64)).astype(np.float32)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs_on(half, float(theta), x.device)
    angles = positions[..., :, None, None].float() * freqs   # (..., S, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# --- activations --------------------------------------------------------------

def squared_relu(x):
    r = torch.clamp(x, min=0.0)
    return r * r


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "gelu": gelu,
    "silu": F.silu,
    "relu": F.relu,
    "squared_relu": squared_relu,
}
