"""Data pipeline: synthetic LM streams, modality stubs, host prefetch.

A copy of ``repro/data/pipeline.py`` (numpy only), so the port draws the
reference's batches bit for bit.

Training data arrives as a *stream* (the paper's producer role): the
pipeline produces deterministic, seedable batches per data-parallel rank;
``Prefetcher`` overlaps host-side batch synthesis with device compute.

``ModalityStub`` implements the assignment's frontend stubs for the
[vlm]/[audio] archs: "precomputed" patch/frame embeddings drawn from a
seeded Gaussian with the right (B, S, d_model) shape and dtype.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


class SyntheticLM:
    """Zipf-distributed token stream with next-token labels.

    Deterministic per (seed, rank): every data-parallel rank draws a
    disjoint substream, so global batches are reproducible regardless of
    cluster size — the property elastic rescaling relies on.
    """

    def __init__(self, vocab_size: int, seq_len: int, *, seed: int = 0,
                 zipf_a: float = 1.2):
        self.vocab = vocab_size
        self.seq = seq_len
        self.seed = seed
        self.zipf_a = zipf_a

    def batch(self, step: int, rank: int, per_rank_batch: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, rank]))
        # zipf over a shuffled vocab (stable shuffle per seed)
        z = rng.zipf(self.zipf_a, size=(per_rank_batch, self.seq + 1))
        toks = (z - 1) % self.vocab
        toks = toks.astype(np.int32)
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


class ModalityStub:
    """Precomputed patch/frame embeddings for vlm/audio backbones."""

    def __init__(self, d_model: int, seq_len: int, *, seed: int = 0,
                 vocab_size: int = 2048, dtype=np.float32):
        self.d = d_model
        self.seq = seq_len
        self.seed = seed
        self.vocab = vocab_size
        self.dtype = dtype

    def batch(self, step: int, rank: int, per_rank_batch: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, rank, 7]))
        emb = rng.normal(0, 1, (per_rank_batch, self.seq, self.d))
        labels = rng.integers(0, self.vocab,
                              (per_rank_batch, self.seq), dtype=np.int32)
        return {"inputs": emb.astype(self.dtype), "labels": labels}


def make_source(cfg, seq_len: int, *, seed: int = 0):
    if cfg.input_mode == "tokens":
        return SyntheticLM(cfg.vocab_size, seq_len, seed=seed)
    return ModalityStub(cfg.d_model, seq_len, seed=seed,
                        vocab_size=cfg.vocab_size)


def make_train_batches(cfg, seq_len: int, global_batch: int, *,
                       rank: int = 0, world: int = 1, seed: int = 0,
                       start_step: int = 0) -> Iterator[dict]:
    """Infinite per-rank batch stream starting at ``start_step``."""
    src = make_source(cfg, seq_len, seed=seed)
    assert global_batch % world == 0, (global_batch, world)
    per_rank = global_batch // world
    step = start_step
    while True:
        yield src.batch(step, rank, per_rank)
        step += 1


class Prefetcher:
    """Host-side prefetch thread: overlap batch synthesis with compute."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for x in self._it:
                self._q.put(x)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        x = self._q.get()
        if x is self._done:
            raise StopIteration
        return x
