"""Synthetic-but-structured data pipeline of the PyTorch port: the
counterpart of ``repro/data/pipeline.py``.

Deterministic synthetic token streams with a power-law unigram
distribution and Markov bigram structure (so that a training loss
falls; uniform tokens have nothing to learn), drawn with numpy exactly
as the reference draws them: the same (seed, step, shard) gives the
same batch in both packages. Each data-parallel shard slices its own
rows; :class:`Prefetcher` double-buffers batches on a host thread.
:func:`spike_stimulus` is the simulator examples' moving bump of extra
drive, in torch on an explicit device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    shard_index: int = 0     # data-parallel host shard
    shard_count: int = 1
    zipf_a: float = 1.2      # unigram power law
    markov_strength: float = 0.7

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # fixed random bigram successor table: tok -> preferred successor
        self._succ = rng.integers(0, v, size=v)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = ranks ** -self.zipf_a
        self._unigram = p / p.sum()

    def _batch_rows(self) -> int:
        if self.batch % self.shard_count:
            raise ValueError(f"batch {self.batch} is not whole shards of "
                             f"{self.shard_count}")
        return self.batch // self.shard_count

    def make_batch(self, step: int) -> dict:
        """Deterministic batch for (step, shard), restart-reproducible:
        {"tokens", "labels"}, each (rows, seq_len) int32 numpy."""
        rows = self._batch_rows()
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.shard_index)
        s = self.seq_len + 1
        toks = rng.choice(self.vocab_size, size=(rows, s),
                          p=self._unigram).astype(np.int32)
        # inject Markov structure: with prob markov_strength the next token
        # is the fixed successor of the previous one
        follow = rng.random((rows, s)) < self.markov_strength
        for t in range(1, s):
            toks[:, t] = np.where(follow[:, t],
                                  self._succ[toks[:, t - 1]], toks[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.make_batch(step)
            step += 1


class Prefetcher:
    """Double-buffered background prefetch (host-side)."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for item in self._it:
            self._q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()


def make_pipeline(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                  shard_index: int = 0, shard_count: int = 1,
                  prefetch: bool = True):
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=shape.global_batch,
                         seq_len=shape.seq_len, seed=seed,
                         shard_index=shard_index, shard_count=shard_count)
    return Prefetcher(iter(pipe)) if prefetch else iter(pipe)


def spike_stimulus(n_columns: int, n: int, t_steps: int,
                   rate_hz: float = 5.0, dt_ms: float = 1.0, *,
                   device="cuda"):
    """(T, C) float32 per-neuron extra rate: a Gaussian bump of width 2
    columns moving 0.1 column a step across the grid. ``n`` is unused,
    as in the reference (whose ``key`` argument draws nothing and is
    dropped here)."""
    ts = torch.arange(t_steps, device=device)
    center = (ts * 0.1) % n_columns
    cols = torch.arange(n_columns, device=device)
    envelope = torch.exp(-0.5 * ((cols[None] - center[:, None]) / 2.0) ** 2)
    return envelope * rate_hz * dt_ms * 1e-3
