"""Deterministic synthetic LM data, numpy only: the port's copy of
``repro.data.synthetic``'s ``DataConfig``, ``SyntheticLM`` and
``Prefetcher`` (the mesh sharding around them is JAX code and stays
there).

A counter-based generator: batch i is a pure function of (seed, i), so a
restarted job resumes with identical batches, and the port draws the same
tokens as the reference, bit for bit.  The stream mixes Zipfian unigrams
with planted motifs, so a model can learn it (uniform tokens give a flat
loss).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 16
    n_motifs: int = 64


class SyntheticLM:
    """Stateless-per-step synthetic corpus."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = ranks ** -cfg.zipf_a
        self._probs = p / p.sum()
        self._motifs = rng.integers(0, v, size=(cfg.n_motifs, cfg.motif_len),
                                    dtype=np.int64)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """{'tokens', 'labels'}: int32 [global_batch, seq_len], labels the
        tokens shifted by one."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab_size, size=(B, S + 1), p=self._probs)
        # plant motifs: predictable spans the model can learn
        mlen = min(cfg.motif_len, (S + 1) // 2)
        n_plant = max(1, S // (4 * mlen))
        for b in range(B):
            ids = rng.integers(0, cfg.n_motifs, size=n_plant)
            pos = rng.integers(0, max(S + 1 - mlen, 1), size=n_plant)
            for m, p0 in zip(ids, pos):
                toks[b, p0:p0 + mlen] = self._motifs[m][:mlen]
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """One-batch-ahead prefetch: the next batch is drawn (and passed
    through ``transform``, e.g. a copy to the card) when the current one
    is handed out, so host data generation overlaps the device step."""

    def __init__(self, it: Iterator, transform: Optional[Callable] = None):
        self._it = it
        self._tf = transform or (lambda x: x)
        self._next = self._tf(next(self._it))

    def __iter__(self):
        return self

    def __next__(self):
        cur = self._next
        self._next = self._tf(next(self._it))
        return cur
