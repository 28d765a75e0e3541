"""The work one call needs, counted from the cell's shapes alone.

The counts say what the algorithm requires, whatever implements it: a
later change that fuses, splits or renames kernels leaves them as they
are.  Operations are the products the macro must form: the ternary MAC
``2 T B K NC`` (``NC = J N`` in NLD mode) on the int8 tensor cores, and in
training also the weight gradient's contraction ``dW = sum_t x_t^T g_t``,
``2 T B K N`` in float32.  Bytes count each operand the macro needs read
once and each result it must write once, never what a kernel reads
again.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"
F32, INT32, INT8 = 4, 4, 1


def peaks(device_kind: str) -> dict | None:
    """The peak rates of ``device_kind`` from the table, or None."""
    return json.loads(PEAKS.read_text()).get(device_kind)


def macro_work(snn: dict, b: int, noisy: bool, train: bool) -> dict:
    """``int8_ops``, ``f32_flops`` and ``bytes`` of one call of the macro
    of configuration ``snn`` over ``b`` streams, under the Fig. 7 noise
    where ``noisy``.

    Inference (one pass over the ``b`` streams): events (T, B, K) int8, the two
    twin-cell planes (K, NC) int8, the codebook, the column scales, the
    soma weights (NLD), the initial membrane (B, N) f32 and, on the clean
    KWN path, the PRBS kicks (T, B, N) f32 that the seam supplies, read;
    spikes (T, B, N) f32, ADC steps (T, B) int32 and the final membrane
    written.  Training (one step over ``batch``) adds the forward's
    residuals, the saturated membrane and the winner mask (T, B, N) f32
    each, written once and read once by the backward, the backward's
    read of the events and of the spikes' gradient, and the weight
    gradient (K, N) f32 and the membrane's (B, N) written.
    """
    t, k, n = snn["n_steps"], snn["n_in"], snn["n_hidden"]
    nld = snn["mode"] == "nld"
    j = snn["n_branches"] if nld else 1
    nc = j * n
    n_codes = 2 ** snn["code_bits"]
    clean_kwn = not nld and snn["use_snl"] and not noisy
    read = (t * b * k * INT8 + 2 * k * nc * INT8
            + (2 * n_codes - 1) * F32 + nc * F32 + (nc if nld else 0) * F32
            + b * n * F32 + (t * b * n * F32 if clean_kwn else 0))
    written = t * b * n * F32 + t * b * INT32 + b * n * F32
    f32_flops = 0
    if train:
        residuals = 2 * t * b * n * F32
        written += residuals + k * n * F32 + b * n * F32
        read += residuals + t * b * k * INT8 + t * b * n * F32
        f32_flops = 2 * t * b * k * n
    return {"int8_ops": 2 * t * b * k * nc, "f32_flops": f32_flops,
            "bytes": read + written}


def ideal_seconds(work: dict, peak: dict) -> tuple[float, float]:
    """(the products at the peak rates, the bytes at the peak bandwidth)
    in seconds."""
    ops = (work["int8_ops"] / peak["int8_ops_per_s"]
           + work["f32_flops"] / peak["f32_flops_per_s"])
    return ops, work["bytes"] / peak["hbm_bytes_per_s"]
