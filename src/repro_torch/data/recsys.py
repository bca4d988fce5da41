"""Criteo-like synthetic recsys stream: per-field categorical ids with
zipf-ish popularity, click labels correlated with a hidden linear model (so
training actually reduces loss), deterministic per (seed, step).

A copy of the reference package's `data/recsys.py` (numpy only): the same
vocabs, offsets, batch, seed and cursor give identical ids and labels."""
from __future__ import annotations

import numpy as np


class CTRStream:
    def __init__(self, field_vocabs, field_offsets, batch: int, seed: int = 0):
        self.vocabs = np.asarray(field_vocabs, dtype=np.int64)
        self.offsets = np.asarray(field_offsets, dtype=np.int64)
        self.batch = batch
        self.seed = seed
        self.step = 0
        rng = np.random.default_rng(seed + 1)
        self._field_w = rng.standard_normal(len(field_vocabs)) * 3.0

    def set_cursor(self, step: int):
        self.step = step

    def next_batch(self) -> dict:
        rng = np.random.default_rng((self.seed, self.step))
        u = rng.random((self.batch, len(self.vocabs)))
        local = np.minimum((self.vocabs[None, :] - 1) * u ** 2,
                           self.vocabs[None, :] - 1).astype(np.int64)
        ids = (local + self.offsets[None, :]).astype(np.int32)
        # hidden signal: popularity-weighted field mix
        sig = ((local / self.vocabs[None, :]) * self._field_w[None, :]).sum(1)
        p = 1.0 / (1.0 + np.exp(-2.0 * (sig - sig.mean())))
        labels = (rng.random(self.batch) < p).astype(np.int32)
        self.step += 1
        return {"ids": ids, "labels": labels}

    def __iter__(self):
        while True:
            yield self.next_batch()
