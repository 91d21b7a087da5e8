"""Synthetic deterministic data pipeline with host-side prefetch: the
port's copy of ``repro.data.pipeline``, NumPy as the reference's is, so a
batch is the reference's bit for bit.

Step-indexed and shard-aware: batch(step, shard, n_shards) is a pure
function, so exact resume after restart/rollback needs no iterator state,
and elastic re-sharding (different n_shards) re-partitions the same global
stream.  A background thread keeps a bounded prefetch queue full — the
host-side analogue of MAGE's lookahead.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 1234
    frames_dim: int = 0     # >0: also emit encoder frame embeddings (audio)


def batch_for_step(cfg: DataConfig, step: int, shard: int = 0,
                   n_shards: int = 1) -> dict[str, np.ndarray]:
    """Deterministic batch: token ids drawn per (step, global row index)."""
    per = cfg.global_batch // n_shards
    rows = np.arange(shard * per, (shard + 1) * per, dtype=np.uint64)
    out: dict[str, np.ndarray] = {}
    rng = np.random.Philox(key=cfg.seed + step)
    gen = np.random.Generator(rng)
    all_tokens = gen.integers(0, cfg.vocab_size,
                              (cfg.global_batch, cfg.seq_len),
                              dtype=np.int32)
    out["tokens"] = all_tokens[rows.astype(np.int64)]
    if cfg.frames_dim:
        frames = gen.normal(0, 1, (cfg.global_batch, cfg.seq_len,
                                   cfg.frames_dim)).astype(np.float32)
        out["frames"] = frames[rows.astype(np.int64)]
    return out


class Prefetcher:
    """Bounded background prefetch of step batches."""

    def __init__(self, cfg: DataConfig, start_step: int, shard: int = 0,
                 n_shards: int = 1, depth: int = 2):
        self.cfg = cfg
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self.shard, self.n_shards = shard, n_shards
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        s = self._step
        while not self._stop.is_set():
            b = batch_for_step(self.cfg, s, self.shard, self.n_shards)
            while not self._stop.is_set():
                try:
                    self.q.put((s, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def next(self) -> tuple[int, dict[str, np.ndarray]]:
        return self.q.get()

    def close(self):
        self._stop.set()
