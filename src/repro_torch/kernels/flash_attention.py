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
the kernel, counted in ``flash_attention_fwd.launches``; a CPU tensor runs
the plain version ``kernels.ref.flash_attention_ref``.
"""

from __future__ import annotations

import ctypes

import torch

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
    if not q.is_cuda:
        raise ValueError(f"unsupported device {q.device}")
    dev = q.device
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
    ops = {name: _operand(t, q.dtype, (bh, s, d), dev)
           for name, t in (("q", q), ("k", k), ("v", v))}
    out = torch.empty_like(q)
    params = _Params(**{name: _ptr(a) for name, a in ops.items()},
                     out=_ptr(out), bh=bh, s=s, d=d, causal=int(causal),
                     dtype=_DTYPE_CODE[q.dtype], scale=1.0 / d ** 0.5)
    _run("flash_attention", "flash_launch", params, dev)
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0


def causal_flops_saving(s: int, bq: int, bk: int) -> float:
    """Fraction of (q block, kv block) pairs the causal gate skips."""
    nq, nk = s // bq, s // bk
    live = sum(1 for i in range(nq) for j in range(nk)
               if j * bk <= i * bq + bq - 1)
    return 1.0 - live / (nq * nk)
