"""Synthetic LM token pipeline: seeded, zipf-distributed tokens with a
learnable bigram structure, numpy only (the JAX package's ``data/lm.py``
imports JAX but computes nothing with it; this copy draws the same tokens
from the same seed).  The serving path draws its request tokens here."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class TokenPipeline:
    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int = 0):
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self._rng = np.random.default_rng(seed)
        # hidden bigram table: next-token bias (gives the model signal)
        self._shift = self._rng.integers(1, vocab, size=64)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        rng = self._rng
        # zipf-ish marginal
        u = rng.random((self.batch, self.seq_len + 1))
        toks = np.floor(self.vocab * u ** 2.2).astype(np.int64) % self.vocab
        # deterministic bigram continuation half the time
        follow = rng.random((self.batch, self.seq_len)) < 0.5
        nxt = (toks[:, :-1] + self._shift[toks[:, :-1] % 64]) % self.vocab
        toks[:, 1:] = np.where(follow, nxt, toks[:, 1:])
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
