"""Tile-plan autotuner: measure candidate (bm, bk, bn) plans, persist winners.

Counterpart of ``repro.tune.autotune``.  The search is the reference's:

1. **Enumerate** candidate triples around the heuristic (bm in multiples
   of 8 up to the batch, bk / bn in multiples of 128 up to one tile),
   the heuristic's own triple always among them, so a tuned plan scored
   no worse than the heuristic under the same stopwatch.
2. **Prior-rank** with a roofline estimate (``prior_seconds``), cheapest
   first, so ``patience`` keeps the promising measurements.
3. **Measure** each candidate (``measure.median_us``, CUDA events on the
   card) on ``ops.fused_macro_seq`` in the serving configuration (gated,
   no MAC telemetry) with the plan pinned.  Every plan gives the same
   bits (the kernels' parity contract, held on the card by
   ``chip_smoke.py``), so the tuner only trades speed.
4. **Score** under ``ms``, ``pj_per_sop`` (a modeled kernel-energy proxy)
   or ``blend``, and persist the winner through ``tune.cache``.

Three things differ from the reference:

* **Dedupe by what the kernels read.**  The CUDA kernels read ``bm`` and
  ``bk`` (the occupancy granularity) and the padded shapes, never ``bn``,
  which only sets column padding.  Candidates are deduped on (bm, bk,
  m_pad, k_pad, nc_pad), so no two measure the same launch; ``bn`` stays
  in the entries for the schema.
* **The prior's launch term.**  The reference adds 1e-4 s per Pallas grid
  iteration, tuned to interpret mode.  A CUDA launch of #1 is two kernels
  whatever the plan; the prior adds ``KERNELS_PER_LAUNCH`` times
  ``LAUNCH_FLOOR_S``, the card's per-launch floor timed by CUDA events
  (``chip_smoke.py`` phase 5, the ``zero_`` of one element: 0.0104 ms on
  an H100 80GB HBM3 at 700 W).
* **The prior's peak rate.**  #1's MAC runs on int8 operands, so the
  prior divides its operations by the int8 tensor-core rate
  (``roofline.analysis.PEAK_INT8_OPS``), not the bf16 one.  The prior
  only orders candidates.

Operands come from ``numpy.random.RandomState``.  ``CANONICAL_CELLS`` are
the reference's four; ``tune()`` is what ``tools/tune_plans_torch.py``
runs.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import energy
from repro_torch.core import ima as ima_lib
from repro_torch.kernels import fused_macro as _fused
from repro_torch.kernels import ops
from repro_torch.launch.hillclimb import prior_guided_search
from repro_torch.roofline import analysis as roofline
from repro_torch.tune import cache, measure

K_WIN = 12
CODE_BITS = 5
DRIVE_GAIN = 0.25

LAUNCH_FLOOR_S = 1.04e-5     # the card's per-launch floor (see above)
KERNELS_PER_LAUNCH = 2       # #1: the head, then the LIF

OBJECTIVES = ("ms", "pj_per_sop", "blend")


class TuneCell(NamedTuple):
    """One autotuning workload: a launch shape + event density + mode."""

    m: int
    k_dim: int
    nc: int
    n: int
    t: int
    density: float
    mode: str = "kwn"
    k: int = K_WIN


# The reference's cells: the physical-macro layer and the 2x2 virtual
# macro, each at the bench's standard event rate and at 1 %.
CANONICAL_CELLS = (
    TuneCell(128, 256, 128, 128, 32, 0.05),
    TuneCell(128, 256, 128, 128, 32, 0.01),
    TuneCell(128, 512, 256, 256, 32, 0.05),
    TuneCell(128, 512, 256, 256, 32, 0.01),
)


def _plan(cell: TuneCell, blocks):
    return _fused.plan_tiles(cell.m, cell.k_dim, cell.nc, cell.n, cell.t,
                             mode=cell.mode, bm=blocks[0], bk=blocks[1],
                             bn=blocks[2], use_cache=False)


def heuristic_blocks(cell: TuneCell) -> tuple[int, int, int]:
    """The heuristic's (bm, bk, bn) for this cell (cache bypassed)."""
    p = _fused.plan_tiles(cell.m, cell.k_dim, cell.nc, cell.n, cell.t,
                          mode=cell.mode, use_cache=False)
    return (p.bm, p.bk, p.bn)


def launch_key(plan) -> tuple:
    """What a launch of the CUDA kernels reads of a plan."""
    return (plan.bm, plan.bk, plan.m_pad, plan.k_pad, plan.nc_pad)


def enumerate_candidates(cell: TuneCell) -> list[tuple[int, int, int]]:
    """Legal (bm, bk, bn) triples, one per distinct launch (``launch_key``),
    the heuristic's triple first in its group, in sorted order.

    bm sweeps 32 / 64 / 128 capped at the batch rounded to 8; bk the
    multiples of 128 dividing K rounded to 128; bn those dividing NC
    rounded to 128.  A triple whose plan the kernels refuse raises
    ``ValueError`` here, before anything is measured.
    """
    m_pad8 = _fused._ceil_mult(cell.m, 8)
    bms = sorted({min(b, m_pad8) for b in (32, 64, 128)})
    k_ceil = _fused._ceil_mult(cell.k_dim, 128)
    bks = [b for b in range(128, k_ceil + 1, 128) if k_ceil % b == 0]
    n_ceil = _fused._ceil_mult(cell.nc, 128)
    bns = [b for b in range(128, n_ceil + 1, 128) if n_ceil % b == 0]
    heur = heuristic_blocks(cell)
    by_launch = {launch_key(_plan(cell, heur)): heur}
    for tr in sorted((bm, bk, bn) for bm in bms for bk in bks for bn in bns):
        plan = _plan(cell, tr)
        _fused.check_plan(plan)
        by_launch.setdefault(launch_key(plan), tr)
    return sorted(by_launch.values())


# --- roofline prior --------------------------------------------------------

def occupied_fraction(density: float, bm: int, bk: int, t: int) -> float:
    """Expected fraction of (bm, bk) activity blocks with >= 1 event under
    ``measure.event_stream``'s bursty model: P(step active) x P(block hit
    | active).  Coarser blocks saturate toward 1.0 faster."""
    burst = measure.IN_BURST_DENSITY
    if t > 1 and density < burst:
        p_step, d_in = density / burst, burst
    else:
        p_step, d_in = 1.0, min(density, 1.0)
    return p_step * (1.0 - (1.0 - d_in) ** (bm * bk))


def prior_seconds(cell: TuneCell, blocks: tuple[int, int, int]) -> float:
    """Analytic cost estimate used only to *order* candidates: the larger
    of the occupied blocks' int8 operations over the int8 peak and the
    streamed bytes over HBM bandwidth, plus the launch's kernels at the
    card's per-launch floor."""
    p = _plan(cell, blocks)
    occ = occupied_fraction(cell.density, p.bm, p.bk, cell.t)
    flops = 2.0 * p.m_pad * p.k_pad * p.nc_pad * cell.t * occ
    n_col = p.nc_pad // p.bn
    # streamed bytes: events once, weight planes re-streamed per column
    # tile and (gating aside) per occupied row/K block
    bytes_ = (cell.t * p.m_pad * p.k_pad
              + 2 * p.k_pad * p.nc_pad * n_col * max(occ, 1.0 / n_col)
              + 4 * cell.t * p.m_pad * p.n_pad)
    return max(flops / roofline.PEAK_INT8_OPS, bytes_ / roofline.HBM_BW) \
        + LAUNCH_FLOOR_S * KERNELS_PER_LAUNCH


# --- modeled kernel-energy objective ---------------------------------------

def modeled_pj_per_sop(cell: TuneCell, blocks: tuple[int, int, int],
                       x, adc_steps_mean: float) -> float:
    """Plan-dependent kernel-energy proxy (pJ per true synaptic op): MAC
    energy per executed element of occupied (bm, bk) blocks times the
    padded column width, ADC energy over padded columns at the measured
    mean early-stop step count, and the digital LIF update, over true
    SOPs (events x fan-out).  ``x`` (T, M, K), a tensor or an array."""
    p = _plan(cell, blocks)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    xm = np.asarray(x).reshape(cell.t, -1, cell.k_dim)
    xm = np.pad(xm, ((0, 0), (0, p.m_pad - xm.shape[1]),
                     (0, p.k_pad - cell.k_dim)))
    occ = (xm != 0).reshape(cell.t, p.m_pad // p.bm, p.bm,
                            p.k_pad // p.bk, p.bk).any(axis=(2, 4))
    executed = float(occ.sum()) * p.bm * p.bk * p.nc_pad
    true_sops = float(np.count_nonzero(np.asarray(x))) * cell.nc
    e_mac = executed * energy.E_MAC_PER_SOP
    e_adc = (cell.t * p.m_pad * p.nc_pad * float(adc_steps_mean)
             * energy.E_ADC_PER_STEP_COL)
    e_lif = cell.t * p.m_pad * cell.k * energy.E_LIF_PER_UPDATE
    return (e_mac + e_adc + e_lif) / max(true_sops, 1.0)


# --- measurement -----------------------------------------------------------

def _operands(cell: TuneCell, seed: int = 0, device=None):
    """Bench-style operands of one cell on ``device``: events from the
    shared bursty stream, random ternary planes, the NLQ ramp, scales and
    membranes, all from one ``numpy.random.RandomState``."""
    dev = device_lib.resolve(device)
    rs = np.random.RandomState(seed)
    x = measure.event_stream(rs, cell.density, (cell.t, cell.m, cell.k_dim))
    msb = rs.randint(-1, 2, size=(cell.k_dim, cell.nc)).astype(np.int8)
    lsb = rs.randint(-1, 2, size=(cell.k_dim, cell.nc)).astype(np.int8)
    scale = rs.uniform(0.05, 0.3, size=(cell.nc,)).astype(np.float32)
    v = (rs.standard_normal((cell.m, cell.n)) * 0.5).astype(np.float32)
    cb = ima_lib.nlq_codebook(CODE_BITS, -24, 24)
    return tuple(torch.from_numpy(a).to(dev) for a in (x, msb, lsb)) + (
        cb.to(dev), torch.from_numpy(scale).to(dev),
        torch.from_numpy(v).to(dev))


def _runner(cell: TuneCell, blocks: tuple[int, int, int]):
    """The serving-configuration launch with the plan pinned."""
    return functools.partial(
        ops.fused_macro_seq, mode=cell.mode, k=cell.k,
        drive_gain=DRIVE_GAIN, gate=True, mac_telemetry=False,
        bm=blocks[0], bk=blocks[1], bn=blocks[2])


class Measurement(NamedTuple):
    blocks: tuple[int, int, int]
    median_ms: float
    pj_per_sop: float


def measure_candidate(cell: TuneCell, blocks: tuple[int, int, int],
                      operands, iters: int) -> Measurement:
    x, msb, lsb, cb, scale, v = operands
    run = functools.partial(_runner(cell, blocks), device=x.device)
    args = (x, msb, lsb, cb.boundaries, cb.levels, scale, v)
    out = run(*args)                        # adc telemetry for the energy term
    adc_mean = float(out[4].float().mean())
    ms = measure.median_ms(
        run, args, iters=iters,
        label=f"candidate {blocks[0]}x{blocks[1]}x{blocks[2]} "
              f"@ {cell.m}x{cell.k_dim}x{cell.n}")
    return Measurement(blocks, ms,
                       modeled_pj_per_sop(cell, blocks, x, adc_mean))


# --- the search ------------------------------------------------------------

def _score(meas: Measurement, heur: Measurement, objective: str,
           blend_weight: float) -> float:
    if objective == "ms":
        return meas.median_ms
    if objective == "pj_per_sop":
        return meas.pj_per_sop
    # geometric blend of the two ratios vs the heuristic: unit-free, and a
    # blend_weight of 0 / 1 recovers the pure objectives
    r_ms = meas.median_ms / heur.median_ms
    r_pj = meas.pj_per_sop / heur.pj_per_sop
    return (r_ms ** (1.0 - blend_weight)) * (r_pj ** blend_weight)


def autotune_cell(cell: TuneCell, *, objective: str = "ms",
                  blend_weight: float = 0.5, iters: int = 9,
                  patience: int | None = None, seed: int = 0,
                  verbose: bool = True, device=None) -> dict:
    """Search one cell on ``device`` (default ``cuda``); returns a cache
    entry (not yet persisted) keyed on that device."""
    if objective not in OBJECTIVES:
        raise ValueError(f"objective {objective!r} not in {OBJECTIVES}")
    dev = device_lib.resolve(device)
    candidates = enumerate_candidates(cell)
    operands = _operands(cell, seed=seed, device=dev)
    heur_blocks = heuristic_blocks(cell)
    heur = measure_candidate(cell, heur_blocks, operands, iters)
    measured = {heur_blocks: heur}

    def evaluate(blocks):
        if blocks not in measured:
            measured[blocks] = measure_candidate(cell, blocks, operands,
                                                 iters)
        m = measured[blocks]
        s = _score(m, heur, objective, blend_weight)
        if verbose:
            print(f"  bm={blocks[0]:>3} bk={blocks[1]:>3} bn={blocks[2]:>3}"
                  f"  {m.median_ms:8.4f} ms  {m.pj_per_sop:8.2f} pJ/SOP"
                  f"  score={s:.4g}"
                  + ("  [heuristic]" if blocks == heur_blocks else ""),
                  flush=True)
        return s

    best_blocks, _, _ = prior_guided_search(
        candidates, evaluate,
        prior=lambda b: prior_seconds(cell, b), patience=patience)
    best = measured[best_blocks]
    return {
        "op": "fused_macro_seq",
        "shape": cache.shape_key(cell.m, cell.k_dim, cell.nc, cell.n,
                                 cell.t),
        "mode": cell.mode,
        "density_bucket": cache.density_bucket(cell.density),
        "device_kind": cache.device_kind(dev),
        "plan": {"bm": best_blocks[0], "bk": best_blocks[1],
                 "bn": best_blocks[2]},
        "objective": objective,
        "score": round(_score(best, heur, objective, blend_weight), 6),
        "median_ms": round(best.median_ms, 4),
        "pj_per_sop": round(best.pj_per_sop, 4),
        "heuristic_median_ms": round(heur.median_ms, 4),
        "speedup_vs_heuristic": round(heur.median_ms / best.median_ms, 4),
        "n_candidates": len(measured),
    }


def _any_entries(entries: list[dict]) -> list[dict]:
    """Per (op, shape, mode, device) group, the best entry re-keyed
    ``any``: the serving paths look plans up with ``density=None``."""
    groups: dict = {}
    for e in entries:
        g = (e["op"], e["shape"], e["mode"], e["device_kind"])
        cur = groups.get(g)
        if cur is None or (e["speedup_vs_heuristic"],
                           e["density_bucket"]) > \
                (cur["speedup_vs_heuristic"], cur["density_bucket"]):
            groups[g] = e
    return [{**groups[g], "density_bucket": cache.ANY_BUCKET}
            for g in sorted(groups)]


def tune(cells=CANONICAL_CELLS, *, objective: str = "ms",
         blend_weight: float = 0.5, iters: int = 9,
         patience: int | None = None, path: str | None = None,
         merge: bool = True, verbose: bool = True, device=None):
    """Autotune every cell on ``device`` and persist the winners (and the
    ``any`` roll-ups).  Returns (entries, path written).  ``merge=True``
    keeps the entries of keys not re-tuned, e.g. another device's."""
    entries = []
    for cell in cells:
        if verbose:
            print(f"[tune] {cache.shape_key(*cell[:5])}"
                  f" d={cell.density} mode={cell.mode}"
                  f" objective={objective}", flush=True)
        entries.append(autotune_cell(
            cell, objective=objective, blend_weight=blend_weight,
            iters=iters, patience=patience, verbose=verbose, device=device))
    entries += _any_entries(entries)
    out = cache.save_entries(entries, path=path, merge=merge)
    if verbose:
        print(f"[tune] wrote {len(entries)} entries -> {out}", flush=True)
    return entries, out
