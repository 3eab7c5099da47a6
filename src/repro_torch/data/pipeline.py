"""Deterministic, seekable, host-sharded synthetic token pipeline.

The port's own copy of the JAX package's ``data/pipeline.py`` (numpy only,
so the arrays are the reference's byte for byte); the trainer moves each
batch to its device.

Production posture:
  * every batch is a pure function of (seed, step, host_shard) — restarts
    resume *exactly* (fault tolerance requires a seekable data source);
  * host sharding: each host materializes only its slice of the global
    batch (``host_id``/``num_hosts``);
  * a double-buffering prefetch thread hides host-side generation latency.

The token distribution is a Zipf-like categorical with a deterministic
per-sequence structure, which gives a non-trivial loss curve (the
quickstart example shows steady descent) without any external data."""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from ..configs.base import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    frontend_len: int = 0
    d_model: int = 0              # for frontend embedding stubs


class SyntheticLM:
    """Seekable synthetic LM stream.  ``batch_at(step)`` is pure."""

    def __init__(self, cfg: DataConfig, host_id: int = 0,
                 num_hosts: int = 1):
        assert cfg.global_batch % num_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        # Zipf-ish unigram distribution, fixed per seed
        r = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._p = p / p.sum()
        self._perm = r.permutation(cfg.vocab_size)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng(
            (c.seed, step, self.host_id, 0xD0D0))
        # markov-ish structure: each sequence repeats a sampled motif with
        # noise, so next-token prediction is learnable
        B, S = self.local_batch, c.seq_len - c.frontend_len
        motif_len = 16
        motifs = self._perm[rng.integers(0, c.vocab_size // 4,
                                         (B, motif_len))]
        reps = (S + 2 * motif_len) // motif_len
        seq = np.tile(motifs, (1, reps))[:, :S + 1]
        noise_mask = rng.random((B, S + 1)) < 0.1
        noise = rng.choice(c.vocab_size, size=(B, S + 1), p=self._p)
        seq = np.where(noise_mask, noise, seq).astype(np.int32)
        out = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
        if c.frontend_len:
            out["frontend_embeds"] = rng.standard_normal(
                (B, c.frontend_len, c.d_model)).astype(np.float32)
        return out

    def iter_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Double-buffered background prefetch with a seekable cursor."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 depth: int = 2):
        self.source = source
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        s = self.step
        while not self._stop.is_set():
            batch = self.source.batch_at(s)
            while not self._stop.is_set():
                try:
                    self._q.put((s, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def next(self):
        s, batch = self._q.get()
        self.step = s + 1
        return s, batch

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)


def data_config_for(cfg: ModelConfig, seq_len: int, global_batch: int,
                    seed: int = 0) -> DataConfig:
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch, seed=seed,
                      frontend_len=cfg.frontend_len if cfg.frontend else 0,
                      d_model=cfg.d_model)


__all__ = ["DataConfig", "SyntheticLM", "Prefetcher", "data_config_for"]
