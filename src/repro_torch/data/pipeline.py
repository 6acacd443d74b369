"""Synthetic-but-learnable data pipeline: a copy of
``repro/data/pipeline.py`` (numpy only; the port keeps its own copy so that
it imports nothing of the reference).  Batches are the reference's bit for
bit, for every ``kind``, step and shard.

Produces next-token-predictable streams so the end-to-end example can show a
falling loss without external datasets (offline container).  Three sources:

* ``lcg``     — order-k Markov stream with a fixed random transition table
                (learnable by any LM; entropy tunable via temperature)
* ``copy``    — delimiter + random span + the same span again (induction)
* ``uniform`` — i.i.d. tokens (loss floor = log V; useful for benchmarks)

The pipeline is deterministic per (seed, step, shard), supports host-sharded
loading (each data-parallel host materializes only its batch slice — the
``Batch.shard_slice`` used by the trainer), and prefetches on a background
thread.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    kind: str = "lcg"          # lcg | copy | uniform
    vocab_size: int = 512
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    markov_order: int = 2
    temperature: float = 0.3   # lower = more predictable


class SyntheticDataset:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        if cfg.kind == "lcg":
            # order-k Markov: context hash -> logits over vocab
            self.n_states = min(4096, cfg.vocab_size ** min(cfg.markov_order, 2))
            logits = rng.normal(size=(self.n_states, cfg.vocab_size))
            probs = np.exp(logits / cfg.temperature)
            self.table = probs / probs.sum(-1, keepdims=True)
            self.mults = rng.integers(
                1, self.n_states, size=cfg.markov_order) * 2 + 1

    def _ctx_state(self, ctx: np.ndarray) -> np.ndarray:
        s = np.zeros(ctx.shape[0], dtype=np.int64)
        for i in range(self.cfg.markov_order):
            s = s + ctx[:, i] * self.mults[i]
        return s % self.n_states

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        """Deterministic batch for (step, shard).  Returns numpy arrays
        tokens/labels of the LOCAL slice (global_batch / n_shards rows)."""
        cfg = self.cfg
        if cfg.global_batch % n_shards:
            raise ValueError("global_batch must divide by n_shards")
        B = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 97 + shard)
        if cfg.kind == "uniform":
            toks = rng.integers(0, cfg.vocab_size, size=(B, cfg.seq_len + 1))
        elif cfg.kind == "copy":
            half = (cfg.seq_len + 1) // 2
            span = rng.integers(1, cfg.vocab_size,
                                size=(B, half))
            toks = np.zeros((B, cfg.seq_len + 1), dtype=np.int64)
            toks[:, :half] = span
            toks[:, half:half * 2] = span[:, :cfg.seq_len + 1 - half]
        else:  # lcg markov
            k = cfg.markov_order
            toks = np.zeros((B, cfg.seq_len + 1 + k), dtype=np.int64)
            toks[:, :k] = rng.integers(0, cfg.vocab_size, size=(B, k))
            for t in range(k, cfg.seq_len + 1 + k):
                state = self._ctx_state(toks[:, t - k:t])
                p = self.table[state]
                c = p.cumsum(-1)
                u = rng.random(size=(B, 1))
                toks[:, t] = (u > c).sum(-1)
            toks = toks[:, k:]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


class Prefetcher:
    """Background-thread prefetch of `SyntheticDataset.batch` results."""

    def __init__(self, ds: SyntheticDataset, start_step: int = 0,
                 shard: int = 0, n_shards: int = 1, depth: int = 2):
        self.ds = ds
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._args = (shard, n_shards)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            b = self.ds.batch(step, *self._args)
            while not self._stop.is_set():
                try:
                    self.q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        step, b = self.q.get()
        return step, b

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)


def loss_floor(cfg: DataConfig) -> float:
    """Entropy of the generating process (nats/token) — the trainer's
    convergence tests check loss approaches this, not zero."""
    if cfg.kind == "uniform":
        return float(np.log(cfg.vocab_size))
    if cfg.kind == "copy":
        return float(np.log(cfg.vocab_size) / 2 + 0.01)
    ds = SyntheticDataset(cfg)
    p = ds.table
    ent = -(p * np.log(np.maximum(p, 1e-12))).sum(-1)
    return float(ent.mean())
