"""The benchmark's traffic generator: Criteo-style recsys batches from a seed.

Frozen copy of ``src/repro_torch/data/synthetic.py`` (``_rng``,
``_splitmix64``, ``hash_weight``, ``zipf_like``, ``RecsysStreamConfig``,
``recsys_batch``), so that a later change to the program's generator moves
no benchmark number. ``recsys_ids`` is new: the same draws in the same
order, without the labels, for the checks that need only the ids.

Every batch is a pure function of ``(seed, batch_idx)``: ids drawn
log-uniform over each field's rows, labels from a hash "teacher".
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np


def _rng(seed: int, batch_idx: int, stream: int = 0) -> np.random.Generator:
    ss = np.random.SeedSequence([seed, batch_idx, stream, 0x5EED])
    return np.random.Generator(np.random.Philox(ss))


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def hash_weight(table_id: int, ids: np.ndarray, scale: float = 0.1) -> np.ndarray:
    """Deterministic teacher weight per (table, id) in [-scale, scale]."""
    h = _splitmix64(ids.astype(np.uint64) * np.uint64(2654435761) + np.uint64(table_id * 40503))
    u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    return ((u * 2.0 - 1.0) * scale).astype(np.float32)


def zipf_like(rng: np.random.Generator, vocab: int, size) -> np.ndarray:
    """Log-uniform rank sampling: heavy-tailed ids with bounded support."""
    u = rng.random(size)
    ids = np.floor(np.exp(u * np.log(max(vocab, 2))) - 1.0).astype(np.int64)
    return np.clip(ids, 0, vocab - 1)


@dataclasses.dataclass(frozen=True)
class RecsysStreamConfig:
    batch: int
    n_dense: int
    n_sparse: int
    vocab_sizes: Sequence[int]
    multi_hot: int = 1
    seed: int = 0

    def __post_init__(self):
        assert len(self.vocab_sizes) == self.n_sparse


def recsys_batch(cfg: RecsysStreamConfig, batch_idx: int) -> Dict[str, np.ndarray]:
    rng = _rng(cfg.seed, batch_idx)
    B, H = cfg.batch, cfg.multi_hot
    dense = rng.normal(size=(B, cfg.n_dense)).astype(np.float32) if cfg.n_dense else np.zeros((B, 0), np.float32)
    ids = np.empty((B, cfg.n_sparse, H), dtype=np.int64)
    logit = np.zeros(B, dtype=np.float32)
    for f, vocab in enumerate(cfg.vocab_sizes):
        ids_f = zipf_like(rng, vocab, (B, H))
        ids[:, f, :] = ids_f
        logit += hash_weight(f, ids_f).sum(axis=-1)
    if cfg.n_dense:
        v = hash_weight(10_000, np.arange(cfg.n_dense, dtype=np.uint64), scale=0.3)
        logit += dense @ v
    p = 1.0 / (1.0 + np.exp(-4.0 * logit))
    label = (rng.random(B) < p).astype(np.float32)
    return dict(dense=dense, sparse_ids=ids.astype(np.int32), label=label)


def recsys_ids(cfg: RecsysStreamConfig, batch_idx: int) -> np.ndarray:
    """``recsys_batch(cfg, batch_idx)["sparse_ids"]``, (B, F, H) int32,
    without the teacher: the dense draw is made (the ids follow it in the
    stream) and the labels are not."""
    rng = _rng(cfg.seed, batch_idx)
    B, H = cfg.batch, cfg.multi_hot
    if cfg.n_dense:
        rng.normal(size=(B, cfg.n_dense))
    ids = np.empty((B, cfg.n_sparse, H), dtype=np.int32)
    for f, vocab in enumerate(cfg.vocab_sizes):
        ids[:, f, :] = zipf_like(rng, vocab, (B, H))
    return ids


def stream_config(cfg: dict, traffic: dict, seed: int) -> RecsysStreamConfig:
    """The stream of a configuration file's sizes under a traffic mix."""
    return RecsysStreamConfig(batch=int(traffic["batch"]), n_dense=int(cfg.get("n_dense", 0)),
                              n_sparse=len(cfg["vocab_sizes"]),
                              vocab_sizes=tuple(int(v) for v in cfg["vocab_sizes"]),
                              multi_hot=int(cfg.get("multi_hot", 1)), seed=int(seed))


def batch_for(stream: RecsysStreamConfig, batch_idx: int) -> Dict[str, np.ndarray]:
    """The batch a train step gets: ``dense`` only where the model has
    dense features."""
    b = recsys_batch(stream, batch_idx)
    if not stream.n_dense:
        del b["dense"]
    return b
