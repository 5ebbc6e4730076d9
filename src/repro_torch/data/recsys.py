"""Synthetic click-log pipeline for DLRM.

Sparse ids are drawn zipf-per-field with *correlated co-access groups*
(user-segment latent variable) so that workload-aware row placement has
something to exploit — mirroring real CTR logs where feature values
co-occur by audience segment.  A numpy copy of the JAX package's pipeline:
the same seed gives bitwise the same batches."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import DLRMConfig
from repro_torch.models.dlrm import table_offsets


class ClickLogPipeline:
    def __init__(self, cfg: DLRMConfig, batch: int, seed: int = 0,
                 n_segments: int = 64, p_segment: float = 0.8):
        self.cfg = cfg
        self.batch = batch
        self._rng = np.random.default_rng(seed)
        self.offsets = table_offsets(cfg)
        self.n_segments = n_segments
        self.p_segment = p_segment

    def _field_ids(self, field: int, segment: np.ndarray) -> np.ndarray:
        """Zipf within segment-specific slices of the vocab."""
        rng = self._rng
        V = self.cfg.vocab_sizes[field]
        B = segment.shape[0]
        u = rng.random(B)
        local = np.minimum((V * u ** 3.0).astype(np.int64), V - 1)
        # map into the segment's stripe with prob p_segment
        use_seg = rng.random(B) < self.p_segment
        stripe = V // self.n_segments
        if stripe > 0:
            seg_local = segment * stripe + (local % stripe)
            local = np.where(use_seg, seg_local, local)
        return local

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        cfg, rng = self.cfg, self._rng
        B = self.batch
        segment = rng.integers(0, self.n_segments, B)
        dense = rng.normal(size=(B, cfg.n_dense)).astype(np.float32)
        cols = []
        for f in range(cfg.n_sparse):
            ids = self._field_ids(f, segment) + self.offsets[f]
            cols.append(ids)
        sparse = np.stack(cols, axis=1).astype(np.int64)
        if cfg.multi_hot > 1:
            sparse = np.repeat(sparse[:, :, None], cfg.multi_hot, axis=2)
        # clicks correlated with dense[0] + segment parity
        logit = dense[:, 0] + (segment % 2) - 0.5
        labels = (rng.random(B) < 1 / (1 + np.exp(-logit))).astype(np.float32)
        return {
            "dense": dense,
            "sparse": sparse.astype(np.int32),
            "labels": labels,
        }
