"""Synthetic LM data pipeline, the reference's `data/lm.py` (numpy, the
same draws): a deterministic zipf-ish token stream with document
structure, packed into fixed-length sequences (causal labels = inputs
shifted left, 0 at the injected document boundaries). Deterministic per
(seed, step), so a restart resumes the cursor exactly and both packages
give the same bytes."""
from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0,
                 doc_len_mean: int = 512):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.doc_len_mean = doc_len_mean
        self.step = 0

    def set_cursor(self, step: int):
        self.step = step

    def next_batch(self) -> dict:
        """{"tokens", "labels"}: int32 [batch, seq_len] numpy arrays."""
        rng = np.random.default_rng((self.seed, self.step))
        # zipf-ish marginal over the vocab (heavy head like natural text)
        n = self.batch * (self.seq_len + 1)
        u = rng.random(n)
        toks = np.minimum((self.vocab - 1) * u ** 3, self.vocab - 1)
        toks = toks.astype(np.int32).reshape(self.batch, self.seq_len + 1)
        # inject EOD boundaries
        eod = rng.random((self.batch, self.seq_len + 1)) < 1.0 / self.doc_len_mean
        toks = np.where(eod, 0, toks)
        self.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def __iter__(self):
        while True:
            yield self.next_batch()
