"""Training tokens: a copy of ``repro_torch/data/pipeline.py``'s
``SyntheticLM`` (Zipf-distributed ids with next-token labels, one
substream per (seed, step, rank)), kept here so that the yardstick does
not change with the program."""
from __future__ import annotations

import numpy as np


class SyntheticLM:
    def __init__(self, vocab_size: int, seq_len: int, *, seed: int = 0,
                 zipf_a: float = 1.2):
        self.vocab = vocab_size
        self.seq = seq_len
        self.seed = seed
        self.zipf_a = zipf_a

    def batch(self, step: int, rank: int, per_rank_batch: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, rank]))
        z = rng.zipf(self.zipf_a, size=(per_rank_batch, self.seq + 1))
        toks = ((z - 1) % self.vocab).astype(np.int32)
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
