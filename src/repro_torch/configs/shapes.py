"""Assigned input-shape sets, one per architecture family: the recsys
family's four shapes (xdeepfm, dlrm-rm2, mind, bert4rec), the gnn family's
(dimenet) and the LM family's (qwen2-0.5b, nemotron-4-15b), with
``block_shape`` for the sampled ``minibatch_lg`` block. The reference's
``FAMILY_SHAPES`` map comes with the 40-cell registry (ROADMAP A6.5)."""

from __future__ import annotations

from typing import Dict, Tuple

LM_SHAPES: Dict[str, dict] = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

RECSYS_SHAPES: Dict[str, dict] = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}

GNN_SHAPES: Dict[str, dict] = {
    "full_graph_sm": dict(kind="train", n_nodes=2708, n_edges=10556, d_feat=1433,
                          n_classes=7, triplets_per_edge=4),
    "minibatch_lg": dict(kind="train", n_nodes=232_965, n_edges=114_615_892,
                         batch_nodes=1024, fanout=(15, 10), d_feat=602,
                         n_classes=41, triplets_per_edge=2),
    "ogb_products": dict(kind="train", n_nodes=2_449_029, n_edges=61_859_140,
                         d_feat=100, n_classes=47, triplets_per_edge=1),
    "molecule": dict(kind="train", n_nodes=30, n_edges=64, batch=128,
                     triplets_per_edge=4),
}


def block_shape(spec: dict) -> Tuple[int, int]:
    """(block_nodes, block_edges) for the sampled minibatch_lg block."""
    bn = spec["batch_nodes"]
    nodes, edges, frontier = bn, 0, bn
    for f in spec["fanout"]:
        new = frontier * f
        edges += new
        nodes += new
        frontier = new
    return nodes, edges


# Reduced shape sets for CPU tests (same code paths, tiny extents).
LM_SHAPES_REDUCED: Dict[str, dict] = {
    "train_4k": dict(kind="train", seq_len=64, global_batch=4),
    "prefill_32k": dict(kind="prefill", seq_len=64, global_batch=2),
    "decode_32k": dict(kind="decode", seq_len=128, global_batch=2),
    "long_500k": dict(kind="decode", seq_len=256, global_batch=1),
}

RECSYS_SHAPES_REDUCED: Dict[str, dict] = {
    "train_batch": dict(kind="train", batch=64),
    "serve_p99": dict(kind="serve", batch=16),
    "serve_bulk": dict(kind="serve", batch=128),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=512),
}

GNN_SHAPES_REDUCED: Dict[str, dict] = {
    "full_graph_sm": dict(kind="train", n_nodes=128, n_edges=512, d_feat=32,
                          n_classes=7, triplets_per_edge=4),
    "minibatch_lg": dict(kind="train", n_nodes=4096, n_edges=65536,
                         batch_nodes=16, fanout=(4, 3), d_feat=16,
                         n_classes=8, triplets_per_edge=2),
    "ogb_products": dict(kind="train", n_nodes=512, n_edges=2048, d_feat=16,
                         n_classes=8, triplets_per_edge=1),
    "molecule": dict(kind="train", n_nodes=12, n_edges=24, batch=4,
                     triplets_per_edge=4),
}
