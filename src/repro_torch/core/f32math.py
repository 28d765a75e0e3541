"""f32 arithmetic that rounds exactly as the JAX reference does on the CPU.

The reference's noise and membrane arithmetic is f32, compiled by XLA for
the CPU.  Six of its operations do not round like PyTorch's CPU kernels,
so the plain PyTorch versions call these instead (the CUDA kernel carries
the same algorithms as device functions in ``csrc/fused_macro_seq_kwn.cu``):

* ``fma``: XLA contracts ``a * b + c`` into one fused multiply-add (one
  rounding) where both operations land in one fused loop, e.g. the LIF
  update ``beta * v + drive``.  Emulated in f64: the product of two f32
  is exact there, and the one remaining double rounding is repaired with
  the exact TwoSum error term before the cast to f32.
* ``div``: on a CUDA tensor, PyTorch computes ``tensor / python number``
  (or a CPU scalar) as a multiplication by the reciprocal, which is not
  the IEEE quotient the reference computes.  ``div`` divides by a device
  tensor, which PyTorch does divide.
* ``sqrtf``: ``torch.sqrt`` on the CPU is not correctly rounded for f32
  (0.7 % of inputs differ by one ULP); the reference's is.  Computed in
  f64 and cast once, which is correctly rounded.
* ``logf``: XLA's f32 log is the Cephes polynomial with fused
  multiply-adds at the polynomial steps and at ``y * x^3 + q1 * e``
  (checked against ``jnp.log`` on every input ``counter_normal`` can
  produce).  ``torch.log`` differs from it by one ULP on ~14 % of inputs.
* ``flush_subnormal``: XLA on the CPU compares a subnormal as a zero of
  its sign; the ramp counts flush their inputs so before they compare.
* ``cosf`` / ``sinf``: the reference calls the C library's single
  precision sine and cosine, which reduce the argument and evaluate
  their polynomials in double precision and round once to f32.  They are
  reproduced here in f64, including the 192-bit large-argument reduction
  for ``|x| >= 120``.
"""

from __future__ import annotations

import math

import torch
from torch._subclasses.fake_tensor import FakeTensor

_F64_INF = float("inf")
_h = float.fromhex


def fma(a, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` with a single rounding (a fused multiply-add).

    Scalars and 0-d tensors join the device of the other operands."""
    dev = next((t.device for t in (a, b, c)
                if isinstance(t, torch.Tensor) and t.dim() > 0), None)
    a, b, c = (torch.as_tensor(t, dtype=torch.float32, device=dev)
               for t in (a, b, c))
    a, b, c = torch.broadcast_tensors(a, b, c)
    p = a.double() * b.double()                  # exact: 24 + 24 bits
    c64 = c.double()
    s = p + c64
    bp = s - c64
    err = (p - bp) + (c64 - (s - bp))            # exact error of s (TwoSum)
    # s may sit exactly on an f32 rounding midpoint that the exact sum
    # does not: step one f64 ulp towards the exact sum before the cast.
    toward = torch.where(err > 0, _F64_INF, -_F64_INF)
    s = torch.where(err != 0, torch.nextafter(s, toward), s)
    return s.float()


def div(a: torch.Tensor, b) -> torch.Tensor:
    """IEEE ``a / b`` with ``b`` a number or a tensor, on any device."""
    return a / torch.as_tensor(b, dtype=a.dtype, device=a.device)


FLT_MIN = float.fromhex("0x1p-126")


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every subnormal value replaced by a zero of its sign.

    XLA on the CPU flushes subnormal inputs to zero before it compares
    (``x > b`` and ``jnp.searchsorted`` alike); the ramp counts call this
    first to compare as it does."""
    return torch.where(torch.abs(x) < FLT_MIN, x * 0.0, x)


def sqrtf(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root."""
    return torch.sqrt(x.double()).float()


# --- log: Cephes polynomial ------------------------------------------------

_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1 = -2.12194440e-4
_LOG_Q2 = 0.693359375
_SQRTHF = 0.707106781186547524


def logf(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive normal f32 values (the reference's rounding)."""
    x = x.float()
    m, e = torch.frexp(x)                        # m in [0.5, 1)
    e = e.float()
    small = m < _SQRTHF
    t = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.float()
    x2 = t * t
    x3 = x2 * t
    p = [torch.tensor(v, dtype=torch.float32) for v in _LOG_P]
    y = fma(t, p[0], p[1])
    y1 = fma(t, p[3], p[4])
    y2 = fma(t, p[6], p[7])
    y = fma(y, t, p[2])
    y1 = fma(y1, t, p[5])
    y2 = fma(y2, t, p[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, e * _LOG_Q1)
    t = t - 0.5 * x2
    t = t + y
    return fma(e, _LOG_Q2, t)


# --- sin / cos: double-precision polynomials ---------------------------------

# (c0, c1, c2, c3, c4) cosine and (s1, s2, s3) sine coefficients; the second
# cosine row is negated (quadrants 2 and 3).
_COS_C = ((1.0, -_h("0x1.ffffffd0c621cp-2"), _h("0x1.55553e1068f19p-5"),
           -_h("0x1.6c087e89a359dp-10"), _h("0x1.99343027bf8c3p-16")),
          (-1.0, _h("0x1.ffffffd0c621cp-2"), -_h("0x1.55553e1068f19p-5"),
           _h("0x1.6c087e89a359dp-10"), -_h("0x1.99343027bf8c3p-16")))
_SIN_S = (-_h("0x1.555545995a603p-3"), _h("0x1.1107605230bc4p-7"),
          -_h("0x1.994eb3774cf24p-13"))
_SIGN = (1.0, -1.0, -1.0, 1.0)
_HPI_INV = _h("0x1.45F306DC9C883p+23")                 # 2/pi * 2^24
_HPI = _h("0x1.921FB54442D18p0")                       # pi/2
_PI63 = _h("0x1.921FB54442D18p-62")                    # 2pi * 2^-64
_INV_PIO4 = (0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e,
             0xf9836e4e, 0x836e4e44, 0x6e4e4415, 0x4e441529,
             0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1,
             0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0,
             0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599,
             0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041)
_TOP_PIO4 = 0x3F4        # top 12 bits (exponent + 3 mantissa) of pi/4
_TOP_TINY = 0x398        # ... of 2^-12
_TOP_120 = 0x42F         # ... of 120.0


def _poly(x: torch.Tensor, x2: torch.Tensor, cos_row: torch.Tensor,
          odd: torch.Tensor) -> torch.Tensor:
    """Sine polynomial where ``odd`` is False, cosine where True (f64)."""
    s1_, s2_, s3_ = _SIN_S
    x3 = x * x2
    s1 = s2_ + x2 * s3_
    x7 = x3 * x2
    sin = (x + x3 * s1_) + x7 * s1
    table = torch.tensor(_COS_C, dtype=torch.float64, device=cos_row.device)
    c = [torch.take(table[:, i], cos_row) for i in range(5)]
    x4 = x2 * x2
    c2 = c[3] + x2 * c[4]
    c1 = c[0] + x2 * c[1]
    x6 = x4 * x2
    cos = (c1 + x4 * c[2]) + x6 * c2
    return torch.where(odd, cos, sin)


def _reduce_large(bits: int) -> tuple[float, int]:
    """192-bit reduction of a float with ``|x| >= 120`` (bits as uint32)."""
    m64 = (1 << 64) - 1
    i = (bits >> 26) & 15
    shift = (bits >> 23) & 7
    xi = (((bits & 0xFFFFFF) | 0x800000) << shift) & 0xFFFFFFFF
    res0 = (xi * _INV_PIO4[i]) & 0xFFFFFFFF
    res1 = xi * _INV_PIO4[i + 4]
    res2 = xi * _INV_PIO4[i + 8]
    res0 = ((res2 >> 32) | (res0 << 32)) & m64
    res0 = (res0 + res1) & m64
    n = ((res0 + (1 << 61)) & m64) >> 62
    res0 = (res0 - (n << 62)) & m64
    signed = res0 - (1 << 64) if res0 >> 63 else res0
    return float(signed) * _PI63, n


def _has_data(t: torch.Tensor) -> bool:
    return not (t.is_meta or isinstance(t, FakeTensor))


def _sincos(y: torch.Tensor, want_cos: bool) -> torch.Tensor:
    y = y.float()
    bits = y.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    top = (bits >> 20) & 0x7FF
    x = y.double()
    # |y| < pi/4: no reduction.
    n = torch.zeros_like(bits)
    xr = x
    # pi/4 <= |y| < 120: one multiply-subtract with pi/2.
    mid = (top >= _TOP_PIO4) & (top < _TOP_120)
    r = (x * _HPI_INV).to(torch.int64)           # truncation, like (int32_t)
    n_mid = (r + 0x800000) >> 24
    xr = torch.where(mid, x - n_mid.double() * _HPI, xr)
    n = torch.where(mid, n_mid, n)
    quad = n.clone()
    # |y| >= 120: exact reduction on the host, element by element (rare).
    # A tensor without data (``meta``, or the dry run's fake tensors) has
    # no values to reduce: it skips the branch, which depends on them.
    large = top >= _TOP_120
    if _has_data(y) and bool(large.any()):
        idx = torch.nonzero(large, as_tuple=True)
        xs, ns = zip(*(_reduce_large(int(b)) for b in bits[idx].tolist()))
        xr = xr.index_put(idx, torch.tensor(xs, dtype=torch.float64,
                                            device=xr.device))
        n_l = torch.tensor(ns, dtype=torch.int64, device=n.device)
        n = n.index_put(idx, n_l)
        quad = quad.index_put(idx, n_l + (bits[idx] >> 31))
    reduced = top >= _TOP_PIO4
    sign = torch.take(torch.tensor(_SIGN, dtype=torch.float64,
                                   device=quad.device), quad & 3)
    sign = torch.where(reduced, sign, torch.ones_like(sign))
    cos_row = torch.where(reduced, (quad >> 1) & 1, torch.zeros_like(quad))
    odd = ((n ^ 1) & 1).bool() if want_cos else (n & 1).bool()
    out = _poly(xr * sign, xr * xr, cos_row, odd).float()
    tiny = top < _TOP_TINY
    return torch.where(tiny, torch.ones_like(y) if want_cos else y, out)


def cosf(y: torch.Tensor) -> torch.Tensor:
    """f32 cosine (the reference's rounding; any finite input)."""
    return _sincos(y, want_cos=True)


def sinf(y: torch.Tensor) -> torch.Tensor:
    """f32 sine (the reference's rounding; any finite input)."""
    return _sincos(y, want_cos=False)


TWO_PI_F32 = float(torch.tensor(2.0 * math.pi, dtype=torch.float32))
