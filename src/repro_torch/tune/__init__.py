"""Tile-plan autotuning for the fused macro kernels.

Counterpart of ``repro.tune``, in three modules:

* ``repro_torch.tune.cache``: the persistent plan cache, a JSON file of
  tuned ``(bm, bk, bn)`` plans keyed on (op, shape, density bucket, mode,
  device kind) that ``kernels.fused_macro.plan_tiles`` consults before
  its heuristic;
* ``repro_torch.tune.measure``: the timing loop (CUDA events on the card)
  and the bursty event stream;
* ``repro_torch.tune.autotune``: the search (enumerate, prior-rank,
  measure, score, persist).

``tools/tune_plans_torch.py`` is the command line.  No cache is
committed: without one every plan is the heuristic's.
"""

from repro_torch.tune import autotune, cache, measure  # noqa: F401
