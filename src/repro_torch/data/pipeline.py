"""Deterministic synthetic token pipeline (shard-aware, prefetched).

The port's copy of ``repro/data/pipeline.py`` (numpy only, unchanged):
batches stay numpy, and the caller moves them to its device.

Produces reproducible batches as a pure function of (seed, step), so any
host in a multi-host launch generates exactly its own shard — no data
server needed, and checkpoint-restart resumes mid-stream for free (the
stream is stateless in step).

Token statistics follow a Zipf-like power law over the vocab with short
repeated motifs so models have learnable structure (loss decreases —
quickstart/train demos rely on that).  The modality stub for [audio]/[vlm]
archs generates matching synthetic frame/patch embeddings.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "SyntheticTokens", "prefetch"]


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # multi-host sharding: this host yields rows [host_id::n_hosts]
    n_hosts: int = 1
    host_id: int = 0
    zipf_a: float = 1.2
    motif_len: int = 16
    # modality stub (encdec/vlm): embeddings (batch, memory_seq, d_model)
    memory_seq: int = 0
    d_model: int = 0


class SyntheticTokens:
    """batch(step) → {"tokens", "labels" [, "memory"]} as numpy arrays."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # precompute zipf probabilities once
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._p = p / p.sum()

    def local_batch_size(self) -> int:
        b, n, h = self.cfg.global_batch, self.cfg.n_hosts, self.cfg.host_id
        assert b % n == 0
        return b // n

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
        b = self.local_batch_size()
        toks = rng.choice(cfg.vocab_size, size=(b, cfg.seq_len + 1), p=self._p)
        # inject repeated motifs (predictable continuations)
        m = cfg.motif_len
        motif = rng.choice(cfg.vocab_size, size=(b, m), p=self._p)
        for rep in range(1, cfg.seq_len // (4 * m)):
            start = rep * 4 * m
            toks[:, start:start + m] = motif
        toks = toks.astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.memory_seq and cfg.d_model:
            out["memory"] = rng.standard_normal(
                (b, cfg.memory_seq, cfg.d_model), dtype=np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Background-thread prefetch (overlaps host data gen with device step)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item
