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

Under a ``plan`` (``nn.module.Plan``) whose tensor-parallel axis cuts a
cell's leaves, each rank of "model" computes its share, as the
reference's layout (``*_specs``) puts the cell over that axis: RG-LRU
its block of the ``d_rnn`` channels, the xLSTM cells their block of the
heads (where the heads divide over the axis; elsewhere the caller takes
the leaves whole and the cell runs whole on every rank).  The input
enters the column-parallel products through ``collectives.copy_to`` and
the row-parallel output projection is summed over the axis
(``layers.row_linear``).  A whole leaf the cell uses a block of
(RG-LRU's ``lam``, xLSTM's ``wi`` / ``wf``, sLSTM's ``r``) is sliced
here, and its gradient is summed over the axis by the caller
(``nn.module.take_param(..., sliced=True)``).  The states keep the
decode cache's layout (``models.lm.cache_axes``): RG-LRU's the rank's
block of its channels, the xLSTM cells' whole over the axis (a cut
cell's decode step reads its heads from the whole state and gathers the
new one whole again).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives
from repro_torch.nn import layers
from repro_torch.nn.module import ParamSpec

NEG_INF = -1e30
MLSTM_CHUNK = 256


def _zeros(shape, device):
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _cut(cols: int, whole: int, plan) -> bool:
    """Whether a leaf of ``cols`` columns, ``whole`` in the whole leaf,
    is this rank's block over ``plan``'s tensor-parallel axis."""
    return plan is not None and plan.tp is not None and cols != whole


def _heads_of(cols: int, whole: int, n_heads: int, plan) -> tuple[int, int]:
    """(first head, heads) of an xLSTM cell's share on this rank: its
    block of the heads where the projection (``cols`` of ``whole``
    columns) is cut, else every head."""
    if not _cut(cols, whole, plan):
        return 0, n_heads
    if n_heads % plan.tp_size:
        raise ValueError(f"{n_heads} heads do not divide over the "
                         f"{plan.tp_size} ranks of {plan.tp!r}: take the "
                         "cell's leaves whole")
    n = n_heads // plan.tp_size
    return plan.tp_index * n, n


def _head_cols(p: dict, h0: int, n: int) -> dict:
    """Columns [h0, h0 + n) of a whole (D, n_heads) projection (the
    cells' projections have no bias)."""
    return {"w": p["w"][:, h0:h0 + n]}


def _entry(x: torch.Tensor, plan, cut: bool) -> torch.Tensor:
    """The input of a cut cell's column-parallel products."""
    return collectives.copy_to(x, plan.mesh, plan.tp) if cut else x


def _exit(p: dict, h: torch.Tensor, plan, cut: bool) -> torch.Tensor:
    """The output projection: row-parallel, summed over the axis, where
    the cell is cut."""
    if cut:
        return layers.row_linear(p, h, plan.mesh, plan.tp)
    return layers.linear(p, h)


def _gathered(state, plan, cut: bool):
    """An xLSTM state of this rank's heads gathered whole over the axis
    (dim 1, the heads), or the state as it is."""
    if not cut:
        return state
    return type(state)(*(collectives.gather_from(t, plan.mesh, plan.tp, 1)
                         for t in state))


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


def mlstm_init_state(b: int, n_heads: int, hd: int,
                     dtype=torch.float32, device=None):
    return MLSTMState(torch.zeros((b, n_heads, hd, hd), dtype=dtype,
                                  device=device),
                      torch.zeros((b, n_heads, hd), dtype=dtype,
                                  device=device),
                      torch.full((b, n_heads), -1e9, dtype=dtype,
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


def _mlstm_gates(p: dict, x: torch.Tensor, h0: int, n: int):
    """(log_f, log_i) (B, S, n) f32 of heads [h0, h0 + n) from x (B, S,
    D)."""
    wi, wf = p["wi"], p["wf"]
    if n != wi["w"].shape[1]:
        wi, wf = _head_cols(wi, h0, n), _head_cols(wf, h0, n)
    log_i = layers.linear(wi, x).float()
    log_f = F.logsigmoid(layers.linear(wf, x).float())
    return log_f, log_i


def _mlstm_qkv(p: dict, x: torch.Tensor, n: int):
    """q, k, v (B, S, n, hd) f32 of the ``n`` heads ``p`` holds."""
    b, s = x.shape[:2]
    return [layers.linear(p[name], x).reshape(b, s, n, -1).float()
            for name in ("wq", "wk", "wv")]


def _mlstm_share(p: dict, x: torch.Tensor, n_heads: int, plan):
    """(the input of the products, first head, heads, cut) of this
    rank's share of an mLSTM cell (module doc)."""
    h0, n = _heads_of(p["wq"]["w"].shape[1], x.shape[-1], n_heads, plan)
    cut = n != n_heads
    return _entry(x, plan, cut), h0, n, cut


def mlstm_forward(p: dict, x: torch.Tensor, n_heads: int,
                  chunk: int = MLSTM_CHUNK, return_state: bool = False,
                  plan=None):
    """x (B, S, D) -> (B, S, D) [, final MLSTMState, whole over the
    heads]; under a ``plan`` that cuts the cell, this rank's heads
    (module doc)."""
    b, s, d = x.shape
    xin, h0, n, cut = _mlstm_share(p, x, n_heads, plan)
    q, k, v = _mlstm_qkv(p, xin, n)
    log_f, log_i = _mlstm_gates(p, xin, h0, n)
    w = min(chunk, s)
    if s % w:
        raise ValueError(f"mLSTM over {s} positions needs a multiple of its "
                         f"chunk {w} (the reference asserts it)")
    state = mlstm_init_state(b, n, d // n_heads, device=x.device)
    hs = []
    for c0 in range(0, s, w):
        sl = slice(c0, c0 + w)
        h, state = _mlstm_chunk(q[:, sl], k[:, sl], v[:, sl], log_f[:, sl],
                                log_i[:, sl], state)
        hs.append(h)
    h = torch.cat(hs, dim=1).reshape(b, s, -1).to(x.dtype)
    o = torch.sigmoid(layers.linear(p["wo_gate"], xin))
    out = _exit(p["wo"], h * o, plan, cut)
    if return_state:
        return out, _gathered(state, plan, cut)
    return out


def mlstm_decode_step(p: dict, x: torch.Tensor, state: MLSTMState,
                      n_heads: int, plan=None
                      ) -> tuple[torch.Tensor, MLSTMState]:
    """x (B, 1, D): a chunk of one.  ``state`` whole over the heads, and
    so is the new one; under a ``plan`` that cuts the cell this rank
    steps its heads and gathers the new state."""
    b = x.shape[0]
    xin, h0, n, cut = _mlstm_share(p, x, n_heads, plan)
    if cut:
        state = MLSTMState(*(t[:, h0:h0 + n] for t in state))
    log_f, log_i = _mlstm_gates(p, xin, h0, n)
    out, new_state = _mlstm_chunk(*_mlstm_qkv(p, xin, n), log_f, log_i,
                                  state)
    h = out.reshape(b, 1, -1).to(x.dtype)
    o = torch.sigmoid(layers.linear(p["wo_gate"], xin))
    return _exit(p["wo"], h * o, plan, cut), _gathered(new_state, plan, cut)


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


def _slstm_share(p: dict, x: torch.Tensor, n_heads: int, plan):
    """(the pre-activations from x (B, S, n, hd, 4) f32 and the
    recurrence (n, hd, 4 hd) f32 of this rank's heads, first head,
    heads, cut): ``wx``'s columns are laid out (H, hd, 4), so its block
    over the axis is the rank's heads (module doc)."""
    b, s, d = x.shape
    h0, n = _heads_of(p["wx"]["w"].shape[1], 4 * d, n_heads, plan)
    cut = n != n_heads
    gx = layers.linear(p["wx"], _entry(x, plan, cut)).float()
    r = p["r"][h0:h0 + n] if cut else p["r"]
    return (gx.reshape(b, s, n, d // n_heads, 4), r.float(), h0, n, cut)


def slstm_forward(p: dict, x: torch.Tensor, n_heads: int,
                  return_state: bool = False, plan=None):
    """x (B, S, D) -> (B, S, D) [, final SLSTMState, whole over the
    heads]; under a ``plan`` that cuts the cell, this rank's heads
    (module doc)."""
    b, s, d = x.shape
    gx, r, _, n, cut = _slstm_share(p, x, n_heads, plan)
    state = slstm_init_state(b, n, d // n_heads, device=x.device)
    hs = []
    for t in range(s):
        state = _slstm_cell(state, gx[:, t], r)
        hs.append(state.h)
    h = torch.stack(hs, dim=1).reshape(b, s, -1).to(x.dtype)
    out = _exit(p["wo"], h, plan, cut)
    if return_state:
        return out, _gathered(state, plan, cut)
    return out


def slstm_decode_step(p: dict, x: torch.Tensor, state: SLSTMState,
                      n_heads: int, plan=None):
    """x (B, 1, D); ``state`` whole over the heads, as in
    ``mlstm_decode_step``."""
    b = x.shape[0]
    gx, r, h0, n, cut = _slstm_share(p, x, n_heads, plan)
    if cut:
        state = SLSTMState(*(t[:, h0:h0 + n] for t in state))
    state = _slstm_cell(state, gx[:, 0], r)
    h = state.h.reshape(b, 1, -1).to(x.dtype)
    return _exit(p["wo"], h, plan, cut), _gathered(state, plan, cut)


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


def _gate(p: dict, u: torch.Tensor, plan, cut: bool) -> torch.Tensor:
    """``sigmoid(u @ w)`` f32; where the cell is cut ``u`` is this
    rank's block of the channels and ``w``'s rows its block: the partial
    products reduce-scattered over the axis along the channels (the
    backward all-gathers), each rank keeping its block of the gate."""
    if not cut:
        return torch.sigmoid(layers.linear(p, u).float())
    y = collectives.psum_scatter(u @ p["w"].to(u.dtype), plan.mesh, plan.tp,
                                 -1)
    return torch.sigmoid(y.float())


def _rglru_gates(p: dict, u: torch.Tensor, plan=None, cut: bool = False):
    r = _gate(p["w_a"], u, plan, cut)
    i = _gate(p["w_x"], u, plan, cut)
    lam = p["lam"]
    if cut:
        n = u.shape[-1]
        lam = lam[plan.tp_index * n:(plan.tp_index + 1) * n]
    log_a = -_C_RGLRU * F.softplus(lam.float()) * r
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


def _rglru_in(p: dict, x: torch.Tensor, plan):
    """(the input of the column-parallel products, cut): the cell is cut
    where ``w_in`` holds a block of the ``lam``'s channels."""
    cut = _cut(p["w_in"]["w"].shape[1], p["lam"].shape[0], plan)
    return _entry(x, plan, cut), cut


def rglru_forward(p: dict, x: torch.Tensor, return_state: bool = False,
                  plan=None):
    """Griffin's recurrent block: in-projection, causal conv, RG-LRU, and
    the gated merge with a GELU branch.  Under a ``plan`` that cuts the
    cell, on this rank's channels, its state theirs (module doc)."""
    xin, cut = _rglru_in(p, x, plan)
    u, tail = _causal_conv(p, layers.linear(p["w_in"], xin))
    a, gated = _rglru_gates(p, u, plan, cut)
    h = _linear_scan(a, gated)
    branch = layers.gelu(layers.linear(p["w_gate_branch"], xin))
    out = _exit(p["w_out"], h.to(x.dtype) * branch, plan, cut)
    if return_state:
        return out, RGLRUState(h[:, -1], tail.float())
    return out


def rglru_decode_step(p: dict, x: torch.Tensor, state: RGLRUState,
                      plan=None) -> tuple[torch.Tensor, RGLRUState]:
    """x (B, 1, D); ``state`` and the new one this rank's channels under
    a ``plan`` that cuts the cell."""
    xin, cut = _rglru_in(p, x, plan)
    u, tail = _causal_conv(p, layers.linear(p["w_in"], xin), state.conv)
    a, gated = _rglru_gates(p, u, plan, cut)
    h = a[:, 0] * state.h + gated[:, 0]
    branch = layers.gelu(layers.linear(p["w_gate_branch"], xin))
    out = _exit(p["w_out"], h[:, None].to(x.dtype) * branch, plan, cut)
    return out, RGLRUState(h, tail.float())
