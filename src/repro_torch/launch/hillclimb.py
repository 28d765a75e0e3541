"""The perf-ladder search of ``repro.launch.hillclimb``: only its generic
core, ``prior_guided_search``, which the tile-plan tuner drives.

The reference's ladders, ``run_cell`` and ``_analyze`` lower models onto
a TPU mesh through ``roofline.flops_model``; they have no counterpart
here yet (they wait for the multi-card slice).
"""

from __future__ import annotations


def prior_guided_search(candidates, evaluate, *, prior=None, better=None,
                        patience=None):
    """Prior-ordered ladder search.

    Visits ``candidates`` in ``prior`` order (an analytic cost estimate,
    cheapest first, so early stopping keeps the most promising
    measurements), calls ``evaluate(candidate) -> score`` on each, and
    keeps the best under ``better(new_score, best_score)`` (default: lower
    is better).  ``patience`` stops the ladder after that many consecutive
    non-improving measurements.  Returns ``(best_candidate, best_score,
    [(candidate, score), ...])`` over the candidates actually measured.
    """
    if better is None:
        better = lambda a, b: a < b   # noqa: E731 — default objective
    ordered = sorted(candidates, key=prior) if prior is not None \
        else list(candidates)
    best = best_score = None
    results = []
    stall = 0
    for cand in ordered:
        score = evaluate(cand)
        results.append((cand, score))
        if best is None or better(score, best_score):
            best, best_score, stall = cand, score, 0
        else:
            stall += 1
            if patience is not None and stall >= patience:
                break
    return best, best_score, results
