"""Deterministic synthetic data generators.

Every batch is a pure function of ``(seed, batch_idx)`` (Philox-keyed), so a
training run restored from a checkpoint replays the *exact* remaining stream
— the property the reader–trainer protocol (§3.1) needs to avoid training a
sample twice.

Recsys streams use a zipf-like (log-uniform rank) distribution over sparse
ids, matching the paper's observation that only a power-law-weighted fraction
of embedding rows is touched per interval (Figs. 3/4). Labels come from a
deterministic hash-based "teacher" so accuracy experiments (Fig. 10) have a
learnable signal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


def _rng(seed: int, batch_idx: int, stream: int = 0) -> np.random.Generator:
    ss = np.random.SeedSequence([seed, batch_idx, stream, 0x5EED])
    return np.random.Generator(np.random.Philox(ss))


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 — deterministic per-id pseudo-random u64."""
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
    """Log-uniform rank sampling — heavy-tailed id distribution with bounded
    support; matches production 'hot rows' access skew."""
    u = rng.random(size)
    ids = np.floor(np.exp(u * np.log(max(vocab, 2))) - 1.0).astype(np.int64)
    return np.clip(ids, 0, vocab - 1)


# --------------------------------------------------------------------- recsys


@dataclasses.dataclass(frozen=True)
class RecsysStreamConfig:
    batch: int
    n_dense: int
    n_sparse: int
    vocab_sizes: Sequence[int]          # one per sparse field
    multi_hot: int = 1                  # ids per field per example (bag size)
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


# ------------------------------------------------------------------------ LM


@dataclasses.dataclass(frozen=True)
class LMStreamConfig:
    batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    bigram_p: float = 0.8  # learnable bigram structure


def lm_batch(cfg: LMStreamConfig, batch_idx: int) -> Dict[str, np.ndarray]:
    rng = _rng(cfg.seed, batch_idx, stream=1)
    B, S, V = cfg.batch, cfg.seq_len, cfg.vocab
    toks = np.empty((B, S + 1), dtype=np.int64)
    toks[:, 0] = rng.integers(0, V, size=B)
    noise = rng.integers(0, V, size=(B, S))
    use_bigram = rng.random((B, S)) < cfg.bigram_p
    for t in range(S):
        nxt = (toks[:, t] * 31 + 7) % V
        toks[:, t + 1] = np.where(use_bigram[:, t], nxt, noise[:, t])
    return dict(tokens=toks[:, :-1].astype(np.int32), labels=toks[:, 1:].astype(np.int32))


# ------------------------------------------------------------ sequential rec


@dataclasses.dataclass(frozen=True)
class SeqRecStreamConfig:
    batch: int
    seq_len: int
    n_items: int
    mask_prob: float = 0.15
    seed: int = 0


def seqrec_batch(cfg: SeqRecStreamConfig, batch_idx: int) -> Dict[str, np.ndarray]:
    """BERT4Rec-style masked item sequences (item 0 reserved as [MASK])."""
    rng = _rng(cfg.seed, batch_idx, stream=2)
    B, S, V = cfg.batch, cfg.seq_len, cfg.n_items
    seq = zipf_like(rng, V - 1, (B, S)) + 1
    nxt = (seq * 131 + 17) % (V - 1) + 1
    use = rng.random((B, S)) < 0.7
    seq[:, 1:] = np.where(use[:, 1:], nxt[:, :-1], seq[:, 1:])
    mask = rng.random((B, S)) < cfg.mask_prob
    mask[:, -1] = True  # always predict the last position
    inputs = np.where(mask, 0, seq)
    return dict(items=inputs.astype(np.int32), labels=seq.astype(np.int32),
                mask=mask)


# ----------------------------------------------------------------- molecules


@dataclasses.dataclass(frozen=True)
class MoleculeStreamConfig:
    batch: int
    n_atoms: int
    n_edges: int            # directed edges per molecule (distance-knn capped)
    n_species: int = 16
    seed: int = 0


def molecule_batch(cfg: MoleculeStreamConfig, batch_idx: int) -> Dict[str, np.ndarray]:
    """Batched small molecules with a learnable pair-potential energy target."""
    rng = _rng(cfg.seed, batch_idx, stream=3)
    B, N, E = cfg.batch, cfg.n_atoms, cfg.n_edges
    pos = rng.normal(size=(B, N, 3)).astype(np.float32) * 1.5
    z = rng.integers(1, cfg.n_species, size=(B, N)).astype(np.int32)
    # kNN-ish edges: for each molecule pick E directed pairs by smallest distance
    d = np.linalg.norm(pos[:, :, None, :] - pos[:, None, :, :], axis=-1)
    d += np.eye(N, dtype=np.float32)[None] * 1e9
    flat = d.reshape(B, -1)
    order = np.argsort(flat, axis=-1)[:, :E]
    src = (order // N).astype(np.int32)
    dst = (order % N).astype(np.int32)
    # teacher energy: sum of species-dependent Morse-like pair terms
    w = hash_weight(77, (z[np.arange(B)[:, None], src].astype(np.uint64) * 131
                         + z[np.arange(B)[:, None], dst].astype(np.uint64)), scale=1.0)
    r = np.take_along_axis(flat, order, axis=-1)
    energy = (w * np.exp(-r)).sum(axis=-1).astype(np.float32)
    return dict(pos=pos, species=z, edge_src=src, edge_dst=dst, energy=energy)


# ------------------------------------------------------------ implicit graph


@dataclasses.dataclass(frozen=True)
class HashGraphConfig:
    """Implicit large graph: neighbor lists are hash-generated on demand so a
    232M-edge graph never has to be materialized to run the neighbor sampler."""

    n_nodes: int
    avg_degree: int
    d_feat: int
    seed: int = 0


class HashGraph:
    def __init__(self, cfg: HashGraphConfig) -> None:
        self.cfg = cfg

    def degree(self, nodes: np.ndarray) -> np.ndarray:
        h = _splitmix64(nodes.astype(np.uint64) + np.uint64(self.cfg.seed * 7919))
        # power-lawish degrees with mean ~ avg_degree
        u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        deg = np.minimum((self.cfg.avg_degree * 0.5 / np.maximum(1e-6, 1 - u)), self.cfg.avg_degree * 50)
        return np.maximum(1, deg.astype(np.int64))

    def neighbors(self, node: int, k: int, rng: np.random.Generator) -> np.ndarray:
        deg = int(self.degree(np.array([node]))[0])
        slots = rng.integers(0, deg, size=k).astype(np.uint64)
        h = _splitmix64(np.uint64(node) * np.uint64(1_000_003) + slots)
        return (h % np.uint64(self.cfg.n_nodes)).astype(np.int64)

    def features(self, nodes: np.ndarray) -> np.ndarray:
        h = _splitmix64(nodes.astype(np.uint64)[:, None] * np.uint64(31)
                        + np.arange(self.cfg.d_feat, dtype=np.uint64)[None, :])
        u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        return (u * 2 - 1).astype(np.float32)

    def labels(self, nodes: np.ndarray, n_classes: int = 47) -> np.ndarray:
        return (_splitmix64(nodes.astype(np.uint64) * np.uint64(97)) % np.uint64(n_classes)).astype(np.int32)


def sample_subgraph(graph: HashGraph, batch_nodes: int, fanouts: Sequence[int],
                    seed: int, batch_idx: int) -> Dict[str, np.ndarray]:
    """GraphSAGE-style layered neighbor sampling over the implicit graph.

    Returns a block with node features for the union frontier plus per-hop
    edge lists (src/dst indices into the node array).
    """
    rng = _rng(seed, batch_idx, stream=4)
    seeds = rng.integers(0, graph.cfg.n_nodes, size=batch_nodes).astype(np.int64)
    all_nodes: List[np.ndarray] = [seeds]
    hops = []
    frontier = seeds
    offset = 0
    for fanout in fanouts:
        nbrs = np.stack([graph.neighbors(int(n), fanout, rng) for n in frontier])
        dst_idx = np.repeat(np.arange(offset, offset + len(frontier)), fanout)
        src_nodes = nbrs.reshape(-1)
        src_idx = np.arange(len(src_nodes)) + offset + len(frontier)
        hops.append((src_idx.astype(np.int32), dst_idx.astype(np.int32)))
        all_nodes.append(src_nodes)
        offset += len(frontier)
        frontier = src_nodes
    nodes = np.concatenate(all_nodes)
    feats = graph.features(nodes)
    return dict(
        node_ids=nodes,
        features=feats,
        labels=graph.labels(seeds),
        hop_src=[h[0] for h in hops],
        hop_dst=[h[1] for h in hops],
        n_seeds=np.int32(batch_nodes),
    )
