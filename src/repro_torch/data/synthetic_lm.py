"""Deterministic synthetic LM data.

Counterpart of ``repro.data.synthetic_lm``: stateless by step, so
``batch_at(step)`` derives every batch from (seed, step) and the
pipeline's state in a checkpoint is the step alone; a resumed run sees
the batches of an uninterrupted one.  Tokens are drawn from a Zipf
unigram distribution (exponent ``zipf_a`` over the vocabulary), and every
``ngram_rep``-th position copies the token ``ngram_rep`` positions
before it, so the loss has structure to learn.

The reference draws with ``jax.random.categorical`` from a JAX key; the
port draws by inverse CDF from ``numpy``'s generator keyed on (seed,
step), the same distribution with other bits.  Tests that need the
reference's bits pass its tokens across.  The copy reads the tokens as
drawn, before any copy, as the reference's functional ``.at[].set``
does: position k * r takes the drawn token at (k - 1) * r, not a copy of
a copy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    ngram_rep: int = 8      # every token is copied this many steps later


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._cdf = np.cumsum(probs / probs.sum())

    def tokens_at(self, step: int) -> np.ndarray:
        """The (global_batch, seq_len) int64 tokens of ``step``."""
        c = self.cfg
        u = np.random.default_rng((c.seed, step)).random(
            (c.global_batch, c.seq_len))
        drawn = np.minimum(np.searchsorted(self._cdf, u, side="right"),
                           c.vocab_size - 1)
        r = c.ngram_rep
        toks = drawn.copy()
        n = toks[:, r::r].shape[1]
        toks[:, r::r] = drawn[:, : (c.seq_len - r) // r * r: r][:, :n]
        return toks

    def batch_at(self, step: int, n_micro: int = 1) -> dict:
        """{"tokens": (global_batch, seq_len)}, or (n_micro, global_batch /
        n_micro, seq_len) for ``n_micro`` > 1; int64 on the host."""
        c = self.cfg
        toks = torch.from_numpy(self.tokens_at(step))
        if n_micro > 1:
            toks = toks.reshape(n_micro, c.global_batch // n_micro,
                                c.seq_len)
        return {"tokens": toks}

    def state(self, step: int) -> dict:
        return {"step": torch.tensor(step, dtype=torch.int32),
                "seed": torch.tensor(self.cfg.seed, dtype=torch.int32)}
