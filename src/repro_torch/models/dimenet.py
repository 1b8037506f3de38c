"""DimeNet (arXiv:2003.03123), in PyTorch: directional message passing with
radial (RBF) and spherical (SBF) bases over edge triplets.

The parameter tree is the reference's (``src/repro/models/dimenet.py``),
``blocks`` stacked ``(n_blocks, ...)`` as its ``vmap`` makes them. Two input
regimes, as there:
  * molecule: true 3-D positions and a species embedding (the species table
    is the arch's only tracked parameter block);
  * generic graph (full_graph_sm, minibatch_lg, ogb_products): nodes carry
    feature vectors, positions are a learned 3-D projection of them, the
    output is node classification. Nothing is tracked: saves are dense-only.

Numerics, held to the reference's on the CPU:
  * Segment sums add in index order, each add rounded to the summands'
    dtype, as XLA's scatter-add on the CPU does (``segment_sum``): bf16
    triplet messages into their edge, f32 edge outputs into their node. They
    run as a loop over the rank of an element within its segment (a few
    ranks: triplets per edge are capped by the data pipeline), each rank one
    gather, add and scatter in which every segment appears at most once, so
    the card adds in the CPU's order too, with no atomics.
  * The bilinear ``einsum("ts,td,sdo->to")`` is formed as XLA forms it: the
    (T, h, n_bilinear) outer products in the compute dtype, then one GEMM
    against ``w_bil`` laid out (h * n_bilinear, h); the (T, n_bilinear, h, h)
    product is never formed.
  * The norms of a triplet's two edge vectors take a zero gradient at a
    zero vector (a self-loop edge, src == dst, which graph batches hold),
    where the reference's ``jnp.linalg.norm`` gives 0 * inf = NaN and its
    graph-mode training turns NaN after one step. The values are the
    reference's (ROADMAP C).
  * Molecule mode runs the batch as one graph, each molecule's nodes, edges
    and triplets offset into it; each molecule's sums keep their own order.

The reference's ``forward_flat_sharded`` (a ``shard_map`` over node and edge
partitions) is mesh machinery and comes with the mesh slice (ROADMAP A6.5);
without a mesh the reference takes ``forward_flat``, as the port does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from ..train.state import TrackedSpec
from .embedding import mlp_apply, mlp_init, take
from .layers import dense_init


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    n_species: int = 95
    d_feat: int = 0            # 0 → molecule mode (species + positions)
    n_out: int = 1             # 1 = energy; else node classes
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def n_sbf(self) -> int:
        return self.n_spherical * self.n_radial


def _radial(d: torch.Tensor, cfg: DimeNetConfig):
    """(n, dc): n = 1..n_radial and d / cutoff clipped to [1e-4, 1], as the
    reference's bases share them (its divide by the constant is a multiply
    by the f32 reciprocal, as XLA compiles it)."""
    n = torch.arange(1, cfg.n_radial + 1, dtype=torch.float32, device=d.device)
    inv = float(np.float32(1.0) / np.float32(cfg.cutoff))
    return n, torch.clamp(d[..., None] * inv, 1e-4, 1.0)


def rbf_basis(d: torch.Tensor, cfg: DimeNetConfig) -> torch.Tensor:
    """Bessel-style radial basis: sin(nπd/c)/d, n = 1..n_radial."""
    n, dc = _radial(d, cfg)
    return (math.sqrt(2.0 / cfg.cutoff) * torch.sin(n * math.pi * dc)
            / (dc * cfg.cutoff))


def sbf_basis(d: torch.Tensor, angle: torch.Tensor, cfg: DimeNetConfig) -> torch.Tensor:
    """Spherical basis: radial sin(nπd/c)/d × angular cos(l·α) products,
    l < n_spherical, n < n_radial → (T, n_spherical * n_radial)."""
    n, dc = _radial(d, cfg)
    radial = torch.sin(n * math.pi * dc) / (dc * cfg.cutoff)        # (T, n_radial)
    l = torch.arange(cfg.n_spherical, dtype=torch.float32, device=d.device)
    angular = torch.cos(l * angle[..., None])                       # (T, n_spherical)
    return (angular[..., :, None] * radial[..., None, :]).reshape(
        tuple(d.shape) + (cfg.n_sbf,))


def init_params(gen: torch.Generator, cfg: DimeNetConfig):
    """Random params on ``gen``'s device, in the reference's tree: each
    block leaf stacked over ``n_blocks``."""
    h, nb = cfg.d_hidden, cfg.n_bilinear

    def block_init():
        return dict(
            w_msg=dense_init(gen, (h, h)),
            w_sbf=dense_init(gen, (cfg.n_sbf, nb)),
            w_bil=dense_init(gen, (nb, h, h), scale=1.0 / np.sqrt(h * nb)),
            mlp=mlp_init(gen, (h, h, h)),
            w_out=dense_init(gen, (h, h)),
        )

    per_block = [block_init() for _ in range(cfg.n_blocks)]
    stack = lambda *leaves: torch.stack(leaves)
    blocks = dict(
        w_msg=stack(*(b["w_msg"] for b in per_block)),
        w_sbf=stack(*(b["w_sbf"] for b in per_block)),
        w_bil=stack(*(b["w_bil"] for b in per_block)),
        mlp=[{k: stack(*(b["mlp"][i][k] for b in per_block)) for k in ("w", "b")}
             for i in range(2)],
        w_out=stack(*(b["w_out"] for b in per_block)),
    )
    dense = dict(
        blocks=blocks,
        rbf_proj=dense_init(gen, (cfg.n_radial, h)),
        edge_mlp=mlp_init(gen, (3 * h, h)),
        out_mlp=mlp_init(gen, (h, h, cfg.n_out)),
    )
    tables = {}
    if cfg.d_feat == 0:
        tables["species"] = dense_init(gen, (cfg.n_species, h), scale=0.1)
    else:
        dense["feat_proj"] = dense_init(gen, (cfg.d_feat, h))
        dense["pos_proj"] = dense_init(gen, (cfg.d_feat, 3), scale=0.01)
    return dict(tables=tables, dense=dense)


def tracked_specs(cfg: DimeNetConfig) -> Dict[str, TrackedSpec]:
    """Only the species embedding is sparse; dense-only in graph mode (the
    intermittent policy then degenerates to full checkpoints)."""
    if cfg.d_feat == 0:
        return {"species": TrackedSpec(path=("tables", "species"),
                                       units=cfg.n_species, rows=cfg.n_species,
                                       dim=cfg.d_hidden)}
    return {}


def _norm(v: torch.Tensor) -> torch.Tensor:
    """sqrt(sum(v * v)) over the last axis, the reference's value, with a
    zero gradient at a zero vector (the reference's is NaN there)."""
    sq = torch.sum(v * v, dim=-1)
    nz = sq > 0
    return torch.where(nz, torch.sqrt(torch.where(nz, sq, 1.0)), 0.0)


class SegmentSum:
    """``jax.ops.segment_sum(x, seg, n)`` as XLA's scatter-add computes it
    on the CPU: the elements of a segment added in index order, each add
    rounded to ``x``'s dtype. Built once per index array: ``ranks[k]``
    holds the k-th element of every segment that has one (as element and
    segment indices), so a sum is one gather, add and scatter a rank, with
    no segment twice in one scatter."""

    def __init__(self, seg: torch.Tensor, n: int):
        seg = seg.to(torch.int64)
        order = torch.argsort(seg, stable=True)
        counts = torch.bincount(seg, minlength=n)
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.empty_like(order)
        rank[order] = torch.arange(seg.numel(), device=seg.device) - starts[seg[order]]
        self.n = n
        self.ranks = []
        for k in range(int(counts.max()) if seg.numel() else 0):
            idx = torch.nonzero(rank == k)[:, 0]
            self.ranks.append((idx, seg[idx]))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        out = x.new_zeros((self.n,) + tuple(x.shape[1:]))
        for idx, seg in self.ranks:
            out = out.index_put((seg,), out[seg] + x[idx])
        return out


def forward_flat(params, batch, cfg: DimeNetConfig) -> torch.Tensor:
    """Single flat graph → per-node outputs (N, n_out) f32.

    batch: features|species, pos?, edge_src, edge_dst, tri_kj, tri_ji.
    """
    cd = cfg.compute_dtype
    f32 = torch.float32
    dense = params["dense"]
    src = batch["edge_src"].to(torch.int64)
    dst = batch["edge_dst"].to(torch.int64)
    if cfg.d_feat == 0:
        h_node = take(params["tables"]["species"], batch["species"])
        pos = batch["pos"]
    else:
        feats = batch["features"].to(cd)
        h_node = feats @ dense["feat_proj"].to(cd)
        pos = (feats @ dense["pos_proj"].to(cd)).to(f32)
    h_node = h_node.to(cd)
    n_nodes = h_node.shape[0]

    # edge geometry
    dvec = pos[dst] - pos[src]                                      # j→i
    dv = dvec.to(f32) + 1e-9
    dist = torch.sqrt(torch.sum(dv * dv, dim=-1))
    rbf = rbf_basis(dist, cfg).to(cd)                               # (E, n_radial)
    rbf_h = rbf @ dense["rbf_proj"].to(cd)                          # (E, h)

    # initial directional messages m_ji = MLP([h_j || h_i || rbf])
    m = mlp_apply(dense["edge_mlp"],
                  torch.cat([h_node[src], h_node[dst], rbf_h], dim=-1),
                  compute_dtype=cd, final_act=True)                 # (E, h)

    # triplet geometry: angle between edge kj and edge ji
    kj = batch["tri_kj"].to(torch.int64)
    ji = batch["tri_ji"].to(torch.int64)
    v1, v2 = dvec[kj].to(f32), dvec[ji].to(f32)
    cosang = torch.sum(v1 * v2, dim=-1) / (_norm(v1) * _norm(v2) + 1e-9)
    angle = torch.arccos(torch.clamp(cosang, -1 + 1e-6, 1 - 1e-6))
    sbf = sbf_basis(dist[kj], angle, cfg).to(cd)                    # (T, n_sbf)

    n_edges, h, nb = m.shape[0], cfg.d_hidden, cfg.n_bilinear
    to_edges = SegmentSum(ji, n_edges)
    to_nodes = SegmentSum(dst, n_nodes)
    blocks = dense["blocks"]
    out_acc = torch.zeros((n_nodes, h), dtype=f32, device=m.device)
    for b in range(cfg.n_blocks):
        m_t = m @ blocks["w_msg"][b].to(cd)                         # (E, h)
        s8 = sbf @ blocks["w_sbf"][b].to(cd)                        # (T, nb)
        outer = (m_t[kj][:, :, None] * s8[:, None, :]).reshape(-1, h * nb)
        w_bil = blocks["w_bil"][b].to(cd).permute(1, 0, 2).reshape(h * nb, h)
        tri = outer @ w_bil                                         # (T, h)
        agg = to_edges(tri)                                         # (E, h)
        mlp = [{k: layer[k][b] for k in layer} for layer in blocks["mlp"]]
        m = m + mlp_apply(mlp, m_t + agg.to(cd), compute_dtype=cd, final_act=True)
        out_acc = out_acc + to_nodes((m @ blocks["w_out"][b].to(cd)).to(f32))
    return mlp_apply(dense["out_mlp"], out_acc.to(cd),
                     compute_dtype=cd).to(f32)                      # (N, n_out)


_MOLECULE_KEYS = ("species", "pos", "edge_src", "edge_dst", "tri_kj", "tri_ji")


def _molecules(params, batch, cfg: DimeNetConfig) -> torch.Tensor:
    """Per-molecule energies (B,): the batch as one graph, each molecule's
    edges offset by its nodes and its triplets by its edges."""
    B, N = batch["species"].shape
    E = batch["edge_src"].shape[1]
    dev = batch["species"].device
    node_off = (torch.arange(B, device=dev) * N)[:, None]
    edge_off = (torch.arange(B, device=dev) * E)[:, None]
    flat = dict(species=batch["species"].reshape(-1),
                pos=batch["pos"].reshape(B * N, 3),
                edge_src=(batch["edge_src"].to(torch.int64) + node_off).reshape(-1),
                edge_dst=(batch["edge_dst"].to(torch.int64) + node_off).reshape(-1),
                tri_kj=(batch["tri_kj"].to(torch.int64) + edge_off).reshape(-1),
                tri_ji=(batch["tri_ji"].to(torch.int64) + edge_off).reshape(-1))
    out = forward_flat(params, flat, cfg).reshape(B, N, -1)
    return torch.sum(out[..., 0], dim=-1)


def train_loss(params, batch, cfg: DimeNetConfig):
    if cfg.d_feat == 0:
        energy = _molecules(params, batch, cfg)                     # (B,)
        loss = torch.mean(torch.square(energy - batch["energy"]))
        with torch.no_grad():
            touched = torch.zeros((cfg.n_species,), dtype=torch.bool,
                                  device=energy.device)
            touched[batch["species"].reshape(-1).to(torch.int64)] = True
            mae = torch.mean(torch.abs(energy - batch["energy"]))
        return loss, dict(mae=mae, touched={"species": touched})
    logits = forward_flat(params, batch, cfg)                       # (N, C)
    labels = batch["labels"].to(torch.int64)
    if "seed_slice" in batch:
        seed_logits = logits[: labels.shape[0]]
    elif "seed_idx" in batch:
        seed_logits = logits[batch["seed_idx"].to(torch.int64)]
    else:
        seed_logits = logits
    lse = torch.logsumexp(seed_logits, dim=-1)
    gold = torch.gather(seed_logits, 1, labels[:, None])[:, 0]
    loss = torch.mean(lse - gold)
    with torch.no_grad():
        acc = torch.mean((torch.argmax(seed_logits, dim=-1) == labels).to(torch.float32))
    return loss, dict(accuracy=acc, touched={})


def serve(params, batch, cfg: DimeNetConfig) -> torch.Tensor:
    """Molecule mode: energies (B,); graph mode: per-node outputs (N, C).
    Without gradients."""
    with torch.no_grad():
        if cfg.d_feat == 0:
            return _molecules(params, {k: batch[k] for k in _MOLECULE_KEYS}, cfg)
        return forward_flat(params, batch, cfg)
