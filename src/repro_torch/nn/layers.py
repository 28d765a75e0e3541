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
from repro_torch.dist import collectives
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


# --- tensor parallelism over one mesh axis (Megatron's layers) -------------
#
# ``x`` is the same on every rank of ``axis`` (a data-parallel row's
# activations) and so is its cotangent; a column-parallel product (``x``
# through ``collectives.copy_to``, then ``linear`` on this rank's block of
# the columns) makes this rank's block of the output columns, a
# row-parallel one its part of the output, summed over the axis.  Under
# sequence parallelism (``seq``) the sum leaves each rank its block of
# the sequence (``collectives.scatter_seq``), where the column-parallel
# product took the sequence gathered (``collectives.gather_seq``).

def row_linear(p: dict, x: torch.Tensor, mesh, axis,
               seq: bool = False) -> torch.Tensor:
    """x (..., F_local), this rank's block of the input features, times
    its block of ``p``'s rows, summed over ``axis`` (with ``seq``,
    reduce-scattered along the sequence, dim 1 of x (B, S, F_local));
    the bias (whole) added once, after the sum."""
    y = x @ p["w"].to(x.dtype)
    y = collectives.scatter_seq(y, mesh, axis) if seq else \
        collectives.reduce_from(y, mesh, axis)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def vocab_block(n_local: int, mesh, axis) -> int:
    """The first row of this rank's block of a table of ``n_local`` rows
    a rank over ``axis``."""
    return mesh.axis_index(axis) * n_local


def embed_vocab(p: dict, ids: torch.Tensor, mesh, axis,
                scale_by_dim: bool = False,
                seq: bool = False) -> torch.Tensor:
    """``embed`` from this rank's block of the table's rows (the
    vocabulary over ``axis``): each rank looks up the ids in its block,
    zero elsewhere, and the rows are summed over the axis; with ``seq``
    (ids (B, S) whole, sequence parallelism) reduce-scattered along the
    sequence, each rank keeping its block of it."""
    table = p["table"]
    v0 = vocab_block(table.shape[0], mesh, axis)
    local = ids - v0
    mine = (local >= 0) & (local < table.shape[0])
    y = table[torch.where(mine, local, torch.zeros_like(local))]
    y = y * mine[..., None].to(y.dtype)
    y = collectives.scatter_seq(y, mesh, axis) if seq else \
        collectives.reduce_from(y, mesh, axis)
    if scale_by_dim:
        y = y * torch.sqrt(torch.tensor(float(table.shape[-1]),
                                        dtype=y.dtype, device=y.device))
    return y


def cim_linear(p: dict, x: torch.Tensor, code_bits: int = 5,
               nlq_gamma: float = 2.0, *, mesh=None,
               axes=()) -> torch.Tensor:
    """CIM-mode linear: ternary twin-cell weights (QAT STE) and NLQ
    activations.

    Weights fake-quantise onto the [-3, 3] twin-cell grid (per-column
    scale); the f32 product goes through the NLQ ramp, its codebook sized
    to the largest magnitude of the whole product (one scale for every row
    of the batch, as the reference has it: with a ``mesh``, the largest
    over the ranks of ``axes``, which hold the batch's other rows).
    """
    w_q = ternary_lib.quantize_weights_ste(p["w"].float())
    y = x.float() @ w_q
    if "b" in p:
        y = y + p["b"].float()
    scale = torch.amax(torch.abs(y.detach()))
    if mesh is not None:
        scale = collectives.pmax(scale, mesh, axes)
    scale = torch.clamp(scale, min=1e-3)
    cb = _on(_nlq_codebook_on, code_bits, nlq_gamma, y.device)
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


def _on(cached, *args):
    """``cached(*args)`` from its per-device cache, except under a fake
    tensor mode (the dry run, ``launch.dryrun``), whose tensors hold no
    data and must not reach a later real call: there it is built anew."""
    if torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is not None:
        return cached.__wrapped__(*args)
    return cached(*args)


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
    freqs = _on(_rope_freqs_on, half, float(theta), x.device)
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
