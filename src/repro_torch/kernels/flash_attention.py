"""Flash-attention forward: the LM stack's prefill and full-sequence
attention.

Counterpart of ``repro.kernels.flash_attention`` (``flash_attention_fwd``,
the Pallas kernel ``_flash_kernel``).  The hand-written CUDA kernel
``csrc/flash_attention.cu`` replaces it: one CTA per 64-row query tile and
(batch x head), the online softmax's running max and sum in registers, a
loop over kv tiles that stops at the last tile a causal row can see; bf16
on the tensor cores (wgmma, P split into two bf16 halves for P V), f32 on
the f32 cores.  It takes any S (it masks the ragged edge itself, so the
wrapper pads nothing), f32 or bf16, causal or full, and any head_dim from
1 to ``MAX_HEAD_DIM`` (padded with zeros inside the kernel's tiles).

There is no backward, as the Pallas kernel has none: the wrapper raises
when grad mode is on and an input requires grad.  A CUDA tensor launches
the kernel through the custom op ``torch.ops.repro_torch.flash_attention``,
counted in ``flash_attention_fwd.launches``; a CPU tensor runs the plain
version ``kernels.ref.flash_attention_ref``.  The op has a fake
implementation (``register_fake``: the output's shape and dtype, nothing
computed) and a FLOP formula (``register_flop_formula``:
``kernel_flops``), so a fake CUDA tensor (``FakeTensorMode``) or a
``meta`` one, as the dry run (``launch.dryrun``) gives it, is counted
and launches nothing and runs no plain version.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ref
from repro_torch.kernels.fused_macro import _operand, _ptr, _run

MAX_HEAD_DIM = 256                  # the widest instantiated tile
MAX_CTAS = 2 ** 31 - 1              # the grid: BH x 64-row query tiles
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class _Params(ctypes.Structure):
    """Mirror of ``FlashParams`` in ``csrc/flash_attention.cu``."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("q", "k", "v", "out")] \
        + [(name, ctypes.c_int) for name in (
            "bh", "s", "d", "causal", "dtype")] + [("scale", ctypes.c_float)]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, bq: int = 128,
                        bk: int = 128) -> torch.Tensor:
    """q, k, v (BH, S, D) -> (BH, S, D) in q's dtype.

    ``bq`` and ``bk`` are the Pallas kernel's block sizes, accepted for
    the same signature: the CUDA kernel's tiles are its own, and the
    result does not depend on them beyond the order of its sums.
    """
    del bq, bk
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention_fwd has no backward (the Pallas "
                           "kernel has none); call it under torch.no_grad()")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal)
    if not (q.is_cuda or q.is_meta):
        raise ValueError(f"unsupported device {q.device}")
    _check(q)
    return torch.ops.repro_torch.flash_attention(q, k, v, causal)


flash_attention_fwd.launches = 0


def _check(q: torch.Tensor) -> None:
    bh, s, d = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash attention takes f32 or bf16, got {q.dtype}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash attention takes head_dim from 1 to "
                         f"{MAX_HEAD_DIM}, got {d}")
    if bh * -(-s // 64) > MAX_CTAS:
        raise ValueError(f"flash attention takes at most {MAX_CTAS} "
                         f"(batch x heads) x 64-row query tiles, got "
                         f"{bh} x {-(-s // 64)}")


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> torch.Tensor:
    """The kernel's launch on CUDA tensors (q, k, v (BH, S, D))."""
    dev = q.device
    bh, s, d = q.shape
    ops = {name: _operand(t, q.dtype, (bh, s, d), dev)
           for name, t in (("q", q), ("k", k), ("v", v))}
    out = torch.empty_like(q)
    params = _Params(**{name: _ptr(a) for name, a in ops.items()},
                     out=_ptr(out), bh=bh, s=s, d=d, causal=int(causal),
                     dtype=_DTYPE_CODE[q.dtype], scale=1.0 / d ** 0.5)
    _run("flash_attention", "flash_launch", params, dev)
    flash_attention_fwd.launches += 1
    return out


@_flash_op.register_fake
def _(q, k, v, causal):
    return torch.empty_like(q)


def _tiles(d: int, dtype: torch.dtype) -> tuple[int, int]:
    """(query rows a CTA, kv rows a tile) of the kernel: bf16 two 64-row
    warpgroups over kv tiles of 64 (32 above D = 128), f32 64 rows over
    tiles of 64 (``csrc/flash_attention.cu``)."""
    if dtype == torch.bfloat16:
        return 128, (32 if d > 128 else 64)
    return 64, 64


def kernel_flops(bh: int, s: int, d: int, causal: bool,
                 dtype: torch.dtype = torch.bfloat16) -> int:
    """The FLOPs of one launch as the kernel does them: 2 D for q.k and
    2 D for p.v on every (query row, kv column) of the kv tiles each CTA
    visits.  Causal, a CTA stops at the last kv tile its rows can see:
    the tiles above the diagonal are skipped and not counted, the masked
    part of the diagonal tiles is computed and counted.  Left out: the
    softmax, the zero padding of D to the instantiated width, and the
    second p.v product of the bf16 path's split of P (its
    ``1.5x the bound's operations``)."""
    rows, kv = _tiles(d, dtype)
    if not causal:
        pairs = s * s
    else:
        pairs = 0
        for q0 in range(0, s, rows):
            end = min(q0 + rows, s)             # the CTA's rows [q0, end)
            pairs += (end - q0) * min(s, ((end - 1) // kv + 1) * kv)
    return 4 * d * bh * pairs


@register_flop_formula(torch.ops.repro_torch.flash_attention, get_raw=True)
def _flash_flops(q, k, v, causal, *args, out_val=None, **kwargs) -> int:
    bh, s, d = q.shape
    return kernel_flops(bh, s, d, causal, q.dtype)


def causal_flops_saving(s: int, bq: int, bk: int) -> float:
    """Fraction of (q block, kv block) pairs the causal gate skips."""
    nq, nk = s // bq, s // bk
    live = sum(1 for i in range(nq) for j in range(nk)
               if j * bk <= i * bq + bq - 1)
    return 1.0 - live / (nq * nk)
