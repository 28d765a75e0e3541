"""Recurrent blocks: xLSTM (chunked mLSTM and sLSTM) and Griffin's RG-LRU.

Counterpart of ``repro.nn.recurrent``; the JAX package computes all of it
outside any Pallas kernel, and so does the port, in plain PyTorch.

mLSTM: the matrix-memory cell with exponential gating, computed chunkwise:
attention inside a chunk in log-gate space, and the recurrent state
(C, n, m) with max-stabilisers carried from chunk to chunk, so the
sequential depth is S / chunk.

sLSTM: the scalar-memory cell with h_{t-1} feeding the gates, a true
recurrence: a loop over time, as the reference's ``lax.scan``.

RG-LRU: Griffin's gated diagonal linear recurrence, h_t = a_t h_{t-1} +
b_t.  The reference runs ``jax.lax.associative_scan``; here it is a
log-depth doubling scan (``_linear_scan``): the same function, its
products and sums taken in another order.

Every cell has a single-step form for decode.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.nn import layers
from repro_torch.nn.module import ParamSpec

NEG_INF = -1e30
MLSTM_CHUNK = 256


def _zeros(shape, device):
    return torch.zeros(shape, dtype=torch.float32, device=device)


# ===========================================================================
# mLSTM (xLSTM matrix cell)
# ===========================================================================

def mlstm_specs(d_model: int, n_heads: int, dtype=torch.float32) -> dict:
    return {
        "wq": layers.linear_spec(d_model, d_model, "embed", "heads",
                                 dtype=dtype),
        "wk": layers.linear_spec(d_model, d_model, "embed", "heads",
                                 dtype=dtype),
        "wv": layers.linear_spec(d_model, d_model, "embed", "heads",
                                 dtype=dtype),
        "wi": layers.linear_spec(d_model, n_heads, "embed", None, dtype=dtype),
        "wf": layers.linear_spec(d_model, n_heads, "embed", None, dtype=dtype),
        "wo_gate": layers.linear_spec(d_model, d_model, "embed", "heads",
                                      dtype=dtype),
        "wo": layers.linear_spec(d_model, d_model, "heads", "embed",
                                 dtype=dtype),
    }


class MLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, hd, hd) stabilised matrix memory
    n: torch.Tensor   # (B, H, hd) stabilised normaliser
    m: torch.Tensor   # (B, H) log-stabiliser


def mlstm_init_state(b: int, n_heads: int, hd: int, device=None):
    return MLSTMState(_zeros((b, n_heads, hd, hd), device),
                      _zeros((b, n_heads, hd), device),
                      torch.full((b, n_heads), -1e9, dtype=torch.float32,
                                 device=device))


_SCAN_BLOCK = 16


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive sum along dim 1 in the order XLA on the CPU takes for
    ``jnp.cumsum``: sequential within blocks of 16, the block totals
    summed so recursively, each block's exclusive prefix added last.  The
    chunk's log-gate sums then equal the reference's bit for bit
    (``torch.cumsum`` moves them by up to 3e-5 at a chunk of 256, which
    the stabilised exponentials carry into the output)."""
    b, n = x.shape[:2]
    nb = -(-n // _SCAN_BLOCK)
    pad = x.new_zeros((b, nb * _SCAN_BLOCK - n, *x.shape[2:]))
    blk = torch.cat([x, pad], dim=1).reshape(b, nb, _SCAN_BLOCK,
                                             *x.shape[2:])
    acc, inner = blk[:, :, 0], [blk[:, :, 0]]
    for i in range(1, _SCAN_BLOCK):
        acc = acc + blk[:, :, i]
        inner.append(acc)
    inner = torch.stack(inner, dim=2)
    if nb > 1:
        tot = _cumsum(inner[:, :, -1])
        excl = torch.cat([torch.zeros_like(tot[:, :1]), tot[:, :-1]], dim=1)
        inner = inner + excl[:, :, None]
    return inner.reshape(b, nb * _SCAN_BLOCK, *x.shape[2:])[:, :n]


def _mlstm_chunk(q, k, v, log_f, log_i, state: MLSTMState):
    """One chunk.  q, k, v (B, W, H, hd) f32; log_f / log_i (B, W, H)."""
    w, hd = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(hd)
    a = _cumsum(log_f)                                  # (B,W,H) inclusive
    total_a = a[:, -1]                                  # (B,H)

    # decay inside the chunk: D[t, s] = a_t - a_s + log_i_s  (s <= t)
    d_mat = a[:, :, None, :] - a[:, None, :, :] + log_i[:, None, :, :]
    tri = torch.ones((w, w), dtype=torch.bool, device=q.device).tril()
    d_mat = torch.where(tri[None, :, :, None], d_mat, NEG_INF)  # (B,T,S,H)

    m_intra = torch.amax(d_mat, dim=2)                  # (B,T,H)
    m_inter = state.m[:, None, :] + a
    m_t = torch.maximum(m_intra, m_inter)

    s_qk = torch.einsum("bthd,bshd->btsh", q, k) * scale
    sp = s_qk * torch.exp(d_mat - m_t[:, :, None, :])
    num_intra = torch.einsum("btsh,bshd->bthd", sp, v)
    den_intra = torch.sum(sp, dim=2)                    # (B,T,H)

    w_inter = torch.exp(m_inter - m_t)
    num_inter = torch.einsum("bthd,bhde->bthe", q, state.c) * scale
    den_inter = torch.einsum("bthd,bhd->bth", q, state.n) * scale
    num = num_intra + num_inter * w_inter[..., None]
    den = den_intra + den_inter * w_inter
    h_out = num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None]

    # the state at the end of the chunk
    b_decay = total_a[:, None, :] - a + log_i           # (B,S,H)
    m_new = torch.maximum(state.m + total_a, torch.amax(b_decay, dim=1))
    w_old = torch.exp(state.m + total_a - m_new)        # (B,H)
    w_s = torch.exp(b_decay - m_new[:, None, :])        # (B,S,H)
    c_new = (state.c * w_old[..., None, None]
             + torch.einsum("bshd,bshe->bhde", w_s[..., None] * k, v))
    n_new = state.n * w_old[..., None] + torch.einsum("bsh,bshd->bhd",
                                                      w_s, k)
    return h_out, MLSTMState(c_new, n_new, m_new)


def _mlstm_gates(p: dict, x: torch.Tensor):
    """(log_f, log_i) (B, S, H) f32 from x (B, S, D)."""
    log_i = layers.linear(p["wi"], x).float()
    log_f = F.logsigmoid(layers.linear(p["wf"], x).float())
    return log_f, log_i


def _mlstm_qkv(p: dict, x: torch.Tensor, n_heads: int):
    b, s, d = x.shape
    return [layers.linear(p[name], x).reshape(b, s, n_heads, d // n_heads)
            .float() for name in ("wq", "wk", "wv")]


def mlstm_forward(p: dict, x: torch.Tensor, n_heads: int,
                  chunk: int = MLSTM_CHUNK, return_state: bool = False):
    """x (B, S, D) -> (B, S, D) [, final MLSTMState]."""
    b, s, d = x.shape
    q, k, v = _mlstm_qkv(p, x, n_heads)
    log_f, log_i = _mlstm_gates(p, x)
    w = min(chunk, s)
    if s % w:
        raise ValueError(f"mLSTM over {s} positions needs a multiple of its "
                         f"chunk {w} (the reference asserts it)")
    state = mlstm_init_state(b, n_heads, d // n_heads, device=x.device)
    hs = []
    for c0 in range(0, s, w):
        sl = slice(c0, c0 + w)
        h, state = _mlstm_chunk(q[:, sl], k[:, sl], v[:, sl], log_f[:, sl],
                                log_i[:, sl], state)
        hs.append(h)
    h = torch.cat(hs, dim=1).reshape(b, s, d).to(x.dtype)
    o = torch.sigmoid(layers.linear(p["wo_gate"], x))
    out = layers.linear(p["wo"], h * o)
    if return_state:
        return out, state
    return out


def mlstm_decode_step(p: dict, x: torch.Tensor, state: MLSTMState,
                      n_heads: int) -> tuple[torch.Tensor, MLSTMState]:
    """x (B, 1, D): a chunk of one."""
    b, _, d = x.shape
    log_f, log_i = _mlstm_gates(p, x)
    out, new_state = _mlstm_chunk(*_mlstm_qkv(p, x, n_heads), log_f, log_i,
                                  state)
    h = out.reshape(b, 1, d).to(x.dtype)
    o = torch.sigmoid(layers.linear(p["wo_gate"], x))
    return layers.linear(p["wo"], h * o), new_state


# ===========================================================================
# sLSTM (xLSTM scalar cell, true recurrence)
# ===========================================================================

def slstm_specs(d_model: int, n_heads: int, dtype=torch.float32) -> dict:
    hd = d_model // n_heads
    return {
        "wx": layers.linear_spec(d_model, 4 * d_model, "embed", "heads",
                                 dtype=dtype),
        # block-diagonal recurrence, one (hd, 4 hd) block a head
        "r": ParamSpec((n_heads, hd, 4 * hd), (None, None, None), dtype,
                       scale=0.02),
        "wo": layers.linear_spec(d_model, d_model, "heads", "embed",
                                 dtype=dtype),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, hd)
    n: torch.Tensor   # (B, H, hd)
    h: torch.Tensor   # (B, H, hd)
    m: torch.Tensor   # (B, H, hd)


def slstm_init_state(b: int, n_heads: int, hd: int, device=None):
    z = _zeros((b, n_heads, hd), device)
    return SLSTMState(z, z, z, torch.full((b, n_heads, hd), -1e9,
                                          dtype=torch.float32, device=device))


def _slstm_cell(state: SLSTMState, gates_x, r):
    """gates_x (B, H, hd, 4) pre-activations from x; r (H, hd, 4 hd)."""
    rec = torch.einsum("bhd,hdk->bhk", state.h, r)
    rec = rec.reshape(*state.h.shape, 4)
    gz, gi, gf, go = (gates_x[..., j] + rec[..., j] for j in range(4))
    z = torch.tanh(gz)
    log_f = F.logsigmoid(gf)
    m_new = torch.maximum(log_f + state.m, gi)
    decay = torch.exp(log_f + state.m - m_new)
    inp = torch.exp(gi - m_new)
    c = decay * state.c + inp * z
    n = decay * state.n + inp
    h = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
    return SLSTMState(c, n, h, m_new)


def _slstm_gates_x(p: dict, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return layers.linear(p["wx"], x).float().reshape(b, s, n_heads,
                                                     d // n_heads, 4)


def slstm_forward(p: dict, x: torch.Tensor, n_heads: int,
                  return_state: bool = False):
    b, s, d = x.shape
    gx = _slstm_gates_x(p, x, n_heads)
    r = p["r"].float()
    state = slstm_init_state(b, n_heads, d // n_heads, device=x.device)
    hs = []
    for t in range(s):
        state = _slstm_cell(state, gx[:, t], r)
        hs.append(state.h)
    h = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    out = layers.linear(p["wo"], h)
    if return_state:
        return out, state
    return out


def slstm_decode_step(p: dict, x: torch.Tensor, state: SLSTMState,
                      n_heads: int):
    b, _, d = x.shape
    state = _slstm_cell(state, _slstm_gates_x(p, x, n_heads)[:, 0],
                        p["r"].float())
    h = state.h.reshape(b, 1, d).to(x.dtype)
    return layers.linear(p["wo"], h), state


# ===========================================================================
# RG-LRU (Griffin / RecurrentGemma)
# ===========================================================================

def rglru_specs(d_model: int, d_rnn: int, conv_width: int = 4,
                dtype=torch.float32) -> dict:
    return {
        "w_in": layers.linear_spec(d_model, d_rnn, "embed", "ffn",
                                   dtype=dtype),
        "w_gate_branch": layers.linear_spec(d_model, d_rnn, "embed", "ffn",
                                            dtype=dtype),
        "conv": ParamSpec((conv_width, d_rnn), ("conv", "ffn"), dtype,
                          scale=0.1),
        "w_a": layers.linear_spec(d_rnn, d_rnn, "ffn", None, dtype=dtype),
        "w_x": layers.linear_spec(d_rnn, d_rnn, "ffn", None, dtype=dtype),
        "lam": ParamSpec((d_rnn,), (None,), dtype, init="ones", scale=1.0),
        "w_out": layers.linear_spec(d_rnn, d_model, "ffn", "embed",
                                    dtype=dtype),
    }


class RGLRUState(NamedTuple):
    h: torch.Tensor          # (B, d_rnn) recurrent state
    conv: torch.Tensor       # (B, conv_width - 1, d_rnn) conv tail


def rglru_init_state(b: int, d_rnn: int, conv_width: int = 4, device=None):
    return RGLRUState(_zeros((b, d_rnn), device),
                      _zeros((b, conv_width - 1, d_rnn), device))


_C_RGLRU = 8.0


def _rglru_gates(p: dict, u: torch.Tensor):
    r = torch.sigmoid(layers.linear(p["w_a"], u).float())
    i = torch.sigmoid(layers.linear(p["w_x"], u).float())
    log_a = -_C_RGLRU * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i * u.float())
    return a, gated


def _causal_conv(p: dict, u: torch.Tensor, state_tail=None):
    """u (B, S, d_rnn); depthwise causal conv of width K.  Returns (out,
    the last K - 1 inputs)."""
    k = p["conv"].shape[0]
    if state_tail is None:
        pad = u.new_zeros((u.shape[0], k - 1, u.shape[2]))
    else:
        pad = state_tail.to(u.dtype)
    up = torch.cat([pad, u], dim=1)
    s = u.shape[1]
    out = up[:, 0:s] * p["conv"][0].to(u.dtype)
    for i in range(1, k):
        out = out + up[:, i:i + s] * p["conv"][i].to(u.dtype)
    return out, up[:, -(k - 1):]


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along dim 1, by doubling:
    after the pass of stride d each element holds the composition of the
    (up to) 2d elements that end at it, so ceil(log2 S) passes cover S."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_forward(p: dict, x: torch.Tensor, return_state: bool = False):
    """Griffin's recurrent block: in-projection, causal conv, RG-LRU, and
    the gated merge with a GELU branch."""
    u, tail = _causal_conv(p, layers.linear(p["w_in"], x))
    a, gated = _rglru_gates(p, u)
    h = _linear_scan(a, gated)
    branch = layers.gelu(layers.linear(p["w_gate_branch"], x))
    out = layers.linear(p["w_out"], h.to(x.dtype) * branch)
    if return_state:
        return out, RGLRUState(h[:, -1], tail.float())
    return out


def rglru_decode_step(p: dict, x: torch.Tensor, state: RGLRUState
                      ) -> tuple[torch.Tensor, RGLRUState]:
    """x (B, 1, D)."""
    u, tail = _causal_conv(p, layers.linear(p["w_in"], x), state.conv)
    a, gated = _rglru_gates(p, u)
    h = a[:, 0] * state.h + gated[:, 0]
    branch = layers.gelu(layers.linear(p["w_gate_branch"], x))
    out = layers.linear(p["w_out"], h[:, None].to(x.dtype) * branch)
    return out, RGLRUState(h, tail.float())
