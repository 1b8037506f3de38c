"""Concrete batch generation for a CellBundle — shapes match
``bundle.make_inputs()`` exactly, values come from the deterministic
synthetic streams, and for the same ``(cell, batch_idx, seed)`` the batch is
the reference's (``src/repro/data/cells.py``) array for array: the recsys
family's train, serve and retrieval cells, dimenet's molecule and graph
cells, and the LM cells. One departure: a decode batch's KV cache is made
by ``init_cache`` on the bundle's device (zeros, as the reference's numpy
ones), since ``decode_32k``'s is 51.5 GB."""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..configs._families import CellBundle
from . import synthetic as syn

_LM_ARCHS = ("olmoe-1b-7b", "dbrx-132b", "nemotron-4-15b", "qwen2-0.5b", "minicpm3-4b")


def build_triplets(src: np.ndarray, dst: np.ndarray, cap: int,
                   total: int) -> tuple:
    """Triplet lists for DimeNet: for each edge e=(j→i), up to ``cap``
    incident edges (k→j). Padded (with self-pairs) to exactly ``total``."""
    E = len(src)
    incoming: Dict[int, list] = {}
    for e in range(E):
        incoming.setdefault(int(dst[e]), []).append(e)
    kj, ji = [], []
    for e in range(E):
        j = int(src[e])
        cnt = 0
        for e_in in incoming.get(j, ()):
            if e_in == e:
                continue
            kj.append(e_in)
            ji.append(e)
            cnt += 1
            if cnt >= cap:
                break
    while len(kj) < total:
        kj.append(len(kj) % E)
        ji.append(len(ji) % E)
    return (np.asarray(kj[:total], np.int32), np.asarray(ji[:total], np.int32))


def _lm_batch(bundle: CellBundle, specs, batch_idx: int, seed: int, rng):
    cfg, kind = bundle.cfg, bundle.kind
    if kind in ("train", "prefill"):
        B, Sq = specs["tokens"].shape
        b = syn.lm_batch(syn.LMStreamConfig(batch=B, seq_len=Sq, vocab=cfg.vocab,
                                            seed=seed), batch_idx)
        return (dict(tokens=b["tokens"], labels=b["labels"]) if kind == "train"
                else dict(tokens=b["tokens"]))
    from ..models.transformer import init_cache

    B = specs["tokens"].shape[0]
    smax = specs["cache"]["k"].shape[2]
    return dict(tokens=rng.integers(0, cfg.vocab, size=(B, 1)).astype(np.int32),
                cache=init_cache(cfg, B, smax, specs["cache"]["k"].dtype, bundle.device),
                cache_len=np.int32(smax // 2))


def _dimenet_batch(bundle: CellBundle, specs, batch_idx: int, seed: int, rng):
    cfg = bundle.cfg
    if bundle.shape == "molecule":
        B, N = specs["species"].shape
        E = specs["edge_src"].shape[1]
        T = specs["tri_kj"].shape[1]
        b = syn.molecule_batch(syn.MoleculeStreamConfig(
            batch=B, n_atoms=N, n_edges=E, n_species=cfg.n_species, seed=seed), batch_idx)
        kj = np.empty((B, T), np.int32)
        ji = np.empty((B, T), np.int32)
        for i in range(B):
            kj[i], ji[i] = build_triplets(b["edge_src"][i], b["edge_dst"][i],
                                          cap=T // E + 1, total=T)
        return dict(species=b["species"], pos=b["pos"],
                    edge_src=b["edge_src"], edge_dst=b["edge_dst"],
                    tri_kj=kj, tri_ji=ji, energy=b["energy"])
    # flat graph shapes
    N, d_feat = specs["features"].shape
    E = specs["edge_src"].shape[0]
    T = specs["tri_kj"].shape[0]
    n_seeds = specs["labels"].shape[0]
    src = rng.integers(0, N, size=E).astype(np.int32)
    dst = ((src.astype(np.int64) * 131 + rng.integers(0, N, size=E)) % N).astype(np.int32)
    kj, ji = build_triplets(src, dst, cap=T // E + 1, total=T)
    graph = syn.HashGraph(syn.HashGraphConfig(n_nodes=N, avg_degree=max(E // N, 1),
                                              d_feat=d_feat, seed=seed))
    nodes = np.arange(N, dtype=np.int64)
    out = dict(features=graph.features(nodes), edge_src=src, edge_dst=dst,
               tri_kj=kj, tri_ji=ji,
               labels=(graph.labels(nodes[:n_seeds]) % cfg.n_out).astype(np.int32))
    if "seed_idx" in specs:
        out["seed_idx"] = np.arange(n_seeds, dtype=np.int32)
    return out


def batch_for_cell(bundle: CellBundle, batch_idx: int, seed: int = 0) -> Dict[str, np.ndarray]:
    specs = bundle.make_inputs()
    arch, kind, cfg = bundle.arch, bundle.kind, bundle.cfg
    rng = np.random.default_rng([seed, batch_idx, 7])
    if arch in _LM_ARCHS:
        return _lm_batch(bundle, specs, batch_idx, seed, rng)
    if arch == "dimenet":
        return _dimenet_batch(bundle, specs, batch_idx, seed, rng)
    if arch in ("dlrm-rm2", "xdeepfm") and kind in ("train", "serve"):
        B = specs["sparse_ids"].shape[0]
        b = syn.recsys_batch(syn.RecsysStreamConfig(
            batch=B, n_dense=getattr(cfg, "n_dense", 0),
            n_sparse=cfg.n_sparse, vocab_sizes=cfg.vocab_sizes,
            multi_hot=cfg.multi_hot, seed=seed), batch_idx)
        out = dict(sparse_ids=b["sparse_ids"])
        if "dense" in specs:
            out["dense"] = b["dense"]
        if kind == "train":
            out["label"] = b["label"]
        return out
    if arch in ("dlrm-rm2", "xdeepfm") and kind == "retrieval":
        b = syn.recsys_batch(syn.RecsysStreamConfig(
            batch=1, n_dense=getattr(cfg, "n_dense", 0),
            n_sparse=cfg.n_sparse, vocab_sizes=cfg.vocab_sizes,
            multi_hot=cfg.multi_hot, seed=seed), batch_idx)
        C = specs["candidate_ids"].shape[0]
        # candidates stand in for field 0, so they are drawn over its table
        out = dict(sparse_ids=b["sparse_ids"],
                   candidate_ids=syn.zipf_like(rng, cfg.vocab_sizes[0], C).astype(np.int32))
        if "dense" in specs:
            out["dense"] = b["dense"]
        return out
    if arch == "mind" and kind in ("train", "serve"):
        B = specs["hist"].shape[0]
        hist = (syn.zipf_like(rng, cfg.n_items - 1, (B, cfg.hist_len)) + 1).astype(np.int32)
        target = (syn.zipf_like(rng, cfg.n_items - 1, (B,)) + 1).astype(np.int32)
        out = dict(hist=hist, target=target)
        if "neg_ids" in specs:
            N = specs["neg_ids"].shape[0]
            out["neg_ids"] = (syn.zipf_like(rng, cfg.n_items - 1, (N,)) + 1).astype(np.int32)
        return out
    if arch == "mind" and kind == "retrieval":
        C = specs["candidate_ids"].shape[0]
        hist = (syn.zipf_like(rng, cfg.n_items - 1, (1, cfg.hist_len)) + 1).astype(np.int32)
        return dict(hist=hist,
                    candidate_ids=(syn.zipf_like(rng, cfg.n_items - 1, (C,)) + 1).astype(np.int32))
    if arch == "bert4rec" and kind == "train":
        B = specs["items"].shape[0]
        b = syn.seqrec_batch(syn.SeqRecStreamConfig(
            batch=B, seq_len=cfg.seq_len, n_items=cfg.n_items, seed=seed), batch_idx)
        N = specs["neg_ids"].shape[0]
        return dict(items=b["items"], labels=b["labels"], mask=b["mask"],
                    neg_ids=(syn.zipf_like(rng, cfg.n_items - 1, (N,)) + 1).astype(np.int32))
    if arch == "bert4rec" and kind == "serve":
        B, Sq = specs["items"].shape
        items = (syn.zipf_like(rng, cfg.n_items - 1, (B, Sq)) + 1).astype(np.int32)
        C = specs["candidate_ids"].shape[1]
        return dict(items=items,
                    candidate_ids=(syn.zipf_like(rng, cfg.n_items - 1, (B, C)) + 1).astype(np.int32))
    if arch == "bert4rec" and kind == "retrieval":
        items = (syn.zipf_like(rng, cfg.n_items - 1, (1, cfg.seq_len)) + 1).astype(np.int32)
        C = specs["candidate_ids"].shape[0]
        return dict(items=items,
                    candidate_ids=(syn.zipf_like(rng, cfg.n_items - 1, (C,)) + 1).astype(np.int32))
    raise ValueError(f"no batch generator for ({arch}, {kind})")
