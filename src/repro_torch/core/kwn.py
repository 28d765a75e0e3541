"""Top-K winner (KWN) selection with ramp early stop (paper C3, Fig. 4).

Counterpart of ``repro.core.kwn``.  After the MAC settles, the IMA sweeps a
descending ramp; the largest MACs cross first, a priority encoder admits
the crossings in column order, and the ramp stops at the K-th winner.

* ``select_codes`` ranks a code plane: descending code, ties to the lower
  column index.  It is the one ranking of the port: ``kwn_select`` here,
  and the fused kernels' plain versions (``kernels.ref.kwn_select``), call
  it.  The key ``code * N + (N - 1 - column)`` orders exactly as the
  reference's ``code - column * (0.5 / N)``, in integers;
* ``kwn_ramp_scan`` is the literal descending sweep (the latency model's
  step count), equal to ``kwn_select`` up to tie handling;
* ``adc_latency_cycles`` / ``lif_latency_updates`` are the latency
  accounting (ADC -30 %, LIF 10x).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import f32math
from repro_torch.core.ima import RampCodebook, ima_convert


class KWNResult(NamedTuple):
    indices: torch.Tensor    # (..., K) winner columns, in ramp order
    codes: torch.Tensor      # (..., K) their codes
    mask: torch.Tensor       # (..., N) 1.0 where the column won
    adc_steps: torch.Tensor  # (...,) int32 ramp steps to the K-th crossing


def select_codes(codes: torch.Tensor, k: int, n_codes: int) -> KWNResult:
    """Descending-ramp priority-encoded top-K on a (..., N) code plane.

    Columns win in order of descending code, ties in index order; code -1
    (padding) never wins.  ``adc_steps`` is ``n_codes - 1`` minus the K-th
    winner's code, or ``n_codes - 1`` when fewer than K columns can win.
    At most N winners are returned.
    """
    n = codes.shape[-1]
    kk = min(k, n)
    idx = torch.arange(n, device=codes.device, dtype=torch.int64)
    key = codes.to(torch.int64) * n + (n - 1 - idx)
    top_key, top_idx = torch.topk(key, kk, dim=-1)
    top_code = torch.div(top_key, n, rounding_mode="floor")
    valid = top_code >= 0
    mask = torch.zeros(codes.shape, dtype=torch.float32, device=codes.device)
    mask.scatter_(-1, top_idx, valid.float())
    reached = valid.sum(-1) >= k
    kth = top_code[..., -1]
    steps = torch.where(reached, n_codes - 1 - kth,
                        torch.full_like(kth, n_codes - 1))
    return KWNResult(top_idx, top_code.to(torch.int32), mask,
                     steps.to(torch.int32))


def kwn_select(mac: torch.Tensor, k: int, cb: RampCodebook) -> KWNResult:
    """Exact top-K with ramp-consistent codes: the columns rank by their
    quantized code (the crossing step), ties by the priority encoder."""
    return select_codes(ima_convert(mac, cb), k, cb.n_codes)


def kwn_ramp_scan(mac: torch.Tensor, k: int, cb: RampCodebook) -> KWNResult:
    """The literal descending ramp: from the top level down, columns whose
    code reaches the level cross, admitted in index order while fewer than
    K have won.  ``adc_steps`` is the first level index at which
    ``min(K, N)`` have won (``n_codes - 1`` if never)."""
    n_codes = cb.n_codes
    n = mac.shape[-1]
    codes_all = ima_convert(mac, cb)
    n_found = torch.zeros(mac.shape[:-1], dtype=torch.int32,
                          device=mac.device)
    mask = torch.zeros(mac.shape, dtype=torch.float32, device=mac.device)
    adc_steps = torch.full(mac.shape[:-1], -1, dtype=torch.int32,
                           device=mac.device)
    for step, level in enumerate(range(n_codes - 1, -1, -1)):
        crossing = (codes_all >= level) & (mask == 0.0)
        order = torch.cumsum(crossing.to(torch.int32), dim=-1)
        admit = crossing & ((n_found[..., None] + order) <= k)
        mask = mask + admit.float()
        n_found = n_found + admit.to(torch.int32).sum(-1, dtype=torch.int32)
        first = (n_found >= min(k, n)) & (adc_steps < 0)
        adc_steps = torch.where(first, torch.full_like(adc_steps, step),
                                adc_steps)
    adc_steps = torch.where(adc_steps < 0,
                            torch.full_like(adc_steps, n_codes - 1),
                            adc_steps)
    score = torch.where(mask > 0, codes_all, torch.full_like(codes_all, -1))
    res = select_codes(score, k, n_codes)
    codes = torch.gather(codes_all, -1, res.indices)
    return KWNResult(res.indices, codes, mask, adc_steps)


def adc_latency_cycles(adc_steps: torch.Tensor, n_codes: int) -> dict:
    """Early-stop ADC latency against the full ramp (the paper measures
    about 30 % saving on DVS Gesture).  The mean is an exact integer sum
    over the count, in f32, as the reference's."""
    full = float(n_codes - 1)
    mean_steps = float(f32math.div(adc_steps.float().sum(),
                                   adc_steps.numel()))
    return {"full_cycles": full, "early_stop_cycles": mean_steps,
            "saving_frac": 1.0 - mean_steps / full}


def lif_latency_updates(k: int, n_neurons: int = 128) -> dict:
    """Serial digital LIF: n updates full against K with KWN (10x at
    K=12, N=128)."""
    return {"full_updates": float(n_neurons), "kwn_updates": float(k),
            "speedup": n_neurons / float(k)}
