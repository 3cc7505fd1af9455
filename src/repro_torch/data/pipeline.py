"""Deterministic synthetic data pipeline (the port's own copy of
``src/repro/data/pipeline.py``: plain numpy, so its batches are byte-equal
to the JAX package's).

Requirements it satisfies (they are what make checkpoint/restart and REBUILD
recovery *exact*):
  * stateless addressing: batch(step) is a pure function of (seed, step) —
    replay after restore reproduces the byte-identical stream;
  * shard-aware: each host materializes only its slice (process_index based;
    a single-process run owns everything);
  * background prefetch with a bounded queue.

Two sources:
  * ``lm_synthetic`` — structured pseudo-text: a mixture of repeated n-grams
    and noise so a real model can actually reduce loss on it (used by the
    trainability integration test and the quickstart example);
  * ``uniform`` — pure uniform tokens (throughput/benchmark use).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "lm_synthetic"  # lm_synthetic | uniform
    ngram: int = 16             # period of the synthetic structure


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))


def make_batch(cfg: DataConfig, step: int, *, lo: int = 0, hi: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Batch rows [lo, hi) of global step ``step`` (host sharding)."""
    hi = cfg.global_batch if hi is None else hi
    rng = _batch_rng(cfg, step)
    B, S = cfg.global_batch, cfg.seq_len
    if cfg.kind == "uniform":
        toks = rng.integers(0, cfg.vocab, (B, S + 1), dtype=np.int64)
    else:
        # a fixed (per-seed) bank of n-grams, tiled with 5% per-step noise:
        # the base patterns are step-independent so the structure is
        # learnable in tens of steps, while the noise keeps batches distinct.
        base_rng = np.random.default_rng(np.random.SeedSequence([cfg.seed]))
        bank = base_rng.integers(0, cfg.vocab, (8, cfg.ngram), dtype=np.int64)
        pick = rng.integers(0, bank.shape[0], (B,))
        base = bank[pick]
        reps = (S + 1 + cfg.ngram - 1) // cfg.ngram
        toks = np.tile(base, (1, reps))[:, : S + 1]
        noise_mask = rng.random((B, S + 1)) < 0.05
        noise = rng.integers(0, cfg.vocab, (B, S + 1), dtype=np.int64)
        toks = np.where(noise_mask, noise, toks)
    toks = toks[lo:hi]
    return {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }


class Pipeline:
    """Prefetching iterator over deterministic steps; resumable via
    ``start_step`` (checkpoint restore passes the step it restored)."""

    def __init__(
        self,
        cfg: DataConfig,
        start_step: int = 0,
        prefetch: int = 2,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.cfg = cfg
        assert cfg.global_batch % process_count == 0
        per = cfg.global_batch // process_count
        self._lo = process_index * per
        self._hi = self._lo + per
        self._step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = make_batch(self.cfg, step, lo=self._lo, hi=self._hi)
            try:
                self._q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            step, batch = self._q.get()
            if step < self._step:
                continue  # stale prefetch after a seek
            self._step = step + 1
            return step, batch

    def close(self):
        self._stop.set()
