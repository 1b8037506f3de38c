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

On a mesh that carries a process group (``launch.mesh.make_host_mesh``),
``train_loss`` takes the reference's distributed forward where it does
(``_use_sharded``): ``forward_flat_sharded``, each rank its range of nodes,
edges and triplets, as a cell of the reference's ``shard_map`` receives
them, with the collectives of ``dist.group_ops``. Molecule mode trains
data-parallel there: each rank its data shard of the molecules, the loss
over the global batch. Serving ignores the mesh, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from ..dist.group_ops import all_gather, all_reduce, group_rank, reduce_scatter
from ..dist.sharding import NO_SHARDING, ShardingRules
from ..train.state import TrackedSpec
from .embedding import mlp_apply, mlp_init, table_lookup, take
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
    no segment twice in one scatter. On the meta device, where an index
    holds no value, a sum is one ``index_add`` of the right shape."""

    def __init__(self, seg: torch.Tensor, n: int):
        seg = seg.to(torch.int64)
        self.n = n
        self.ranks = []
        if seg.device.type == "meta":
            self.seg = seg
            return
        self.seg = None
        order = torch.argsort(seg, stable=True)
        counts = torch.bincount(seg, minlength=n)
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.empty_like(order)
        rank[order] = torch.arange(seg.numel(), device=seg.device) - starts[seg[order]]
        for k in range(int(counts.max()) if seg.numel() else 0):
            idx = torch.nonzero(rank == k)[:, 0]
            self.ranks.append((idx, seg[idx]))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        out = x.new_zeros((self.n,) + tuple(x.shape[1:]))
        if self.seg is not None:
            return out.index_add(0, self.seg, x)
        for idx, seg in self.ranks:
            out = out.index_put((seg,), out[seg] + x[idx])
        return out


def _node_sums(dense, cfg: DimeNetConfig, h_node, pos, src, dst, kj, ji,
               n_nodes: int) -> torch.Tensor:
    """The message passing from node embeddings ``h_node`` and positions
    ``pos`` (all N nodes) over the edges ``src → dst`` and the triplets
    (``kj``, ``ji``, indices into these edges): the (n_nodes, h) f32 sum
    over the blocks of each block's edge outputs, summed into their ``dst``
    node in edge order."""
    cd, f32 = cfg.compute_dtype, torch.float32
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
    return out_acc


def forward_flat(params, batch, cfg: DimeNetConfig,
                 rules: ShardingRules = NO_SHARDING) -> torch.Tensor:
    """Single flat graph → per-node outputs (N, n_out) f32, on one process
    (``rules`` constrain nothing here: a tensor of the port lives whole on
    its rank).

    batch: features|species, pos?, edge_src, edge_dst, tri_kj, tri_ji.
    """
    del rules
    cd = cfg.compute_dtype
    dense = params["dense"]
    if cfg.d_feat == 0:
        h_node = take(params["tables"]["species"], batch["species"])
        pos = batch["pos"]
    else:
        feats = batch["features"].to(cd)
        h_node = feats @ dense["feat_proj"].to(cd)
        pos = (feats @ dense["pos_proj"].to(cd)).to(torch.float32)
    h_node = h_node.to(cd)
    out_acc = _node_sums(dense, cfg, h_node, pos,
                         batch["edge_src"].to(torch.int64),
                         batch["edge_dst"].to(torch.int64),
                         batch["tri_kj"].to(torch.int64),
                         batch["tri_ji"].to(torch.int64), h_node.shape[0])
    return mlp_apply(dense["out_mlp"], out_acc.to(cd),
                     compute_dtype=cd).to(torch.float32)            # (N, n_out)


def _shards(batch, rules: ShardingRules):
    """(node axes, shard count) of a flat-graph batch under ``rules``: the
    mesh axes ``nodes`` maps to at this node count, and their product."""
    axes = rules.axes_for("nodes", batch["features"].shape[0])
    if not axes:
        return (), 1
    return axes, math.prod(rules.mesh.shape[a] for a in axes)


def _use_sharded(batch, cfg: DimeNetConfig, rules: ShardingRules) -> bool:
    """The reference's test: a mesh, graph mode, node, edge and triplet
    counts that each divide by the node axes' shard count, and at least 8
    nodes a shard."""
    if rules.mesh is None or cfg.d_feat == 0:
        return False
    N, E = batch["features"].shape[0], batch["edge_src"].shape[0]
    T = batch["tri_kj"].shape[0]
    axes, n = _shards(batch, rules)
    if not axes:
        return False
    return all(x % n == 0 for x in (N, E, T)) and N // n >= 8


def _shard_group(batch, rules: ShardingRules):
    """(group, shard index, shard count) of this rank for the sharded
    forward: the subgroup of the node axes, and this rank's index over
    them (the first axis outermost, as ``shard_map`` linearizes them),
    which is its rank in that subgroup. Raises without a group."""
    mesh = rules.mesh
    if mesh is None or not getattr(mesh, "has_group", False):
        raise ValueError(
            "the sharded DimeNet forward runs across the ranks of a mesh that carries "
            "a torch.distributed group (launch.mesh.make_host_mesh); these rules' "
            f"mesh is {mesh!r}. Use forward_flat on one process")
    axes, n = _shards(batch, rules)
    if not axes:
        raise ValueError(f"{batch['features'].shape[0]} nodes do not shard over {mesh!r}")
    group = mesh.group_for(axes)
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + mesh.axis_index(a)
    if group_rank(group) != i:
        raise ValueError(f"rank {group_rank(group)} of the node axes' group is shard {i}")
    return group, i, n


def forward_flat_sharded(params, batch, cfg: DimeNetConfig,
                         rules: ShardingRules) -> torch.Tensor:
    """The reference's distributed flat-graph forward, one rank of it: this
    rank's (N_l, n_out) rows.

    Every rank takes the global batch and slices its own ranges: nodes,
    edges and triplets, each range-partitioned over the mesh axes ``nodes``
    maps to, in the order ``shard_map`` gives its cells (``_shard_group``).
    Per rank: its node embeddings (compute dtype) and positions (f32) are
    all-gathered to (N, h) and (N, 3); its E_l edges get their geometry and
    initial messages; each triplet's edge indices are taken into the rank's
    own edge range, ``kj % E_l`` and ``ji % E_l``, the reference's locality
    clamp (``src/repro/models/dimenet.py:215-216``), copied as it is: where
    a triplet's edges lie outside its range, this computes another function
    than ``forward_flat``, the same as ``forward_flat`` on the batch with
    ``kj`` → r·E_l + kj % E_l and ``ji`` → r·E_l + ji % E_l for the
    triplets of range r; the blocks run on the rank's edges (segment sums
    in index order within the rank); the node contributions, over all N
    nodes, are reduce-scattered (sum) to the rank's N_l rows, and
    ``out_mlp`` applies there.

    The collectives are ``dist.group_ops``' and differentiable: backward,
    the all-gathers' cotangents are reduce-scattered and the
    reduce-scatter's all-gathered. There is no fallback: without a group
    this raises, and never runs ``forward_flat`` in its place."""
    group, i, n = _shard_group(batch, rules)
    cd, f32 = cfg.compute_dtype, torch.float32
    dense = params["dense"]
    N = batch["features"].shape[0]
    E, T = batch["edge_src"].shape[0], batch["tri_kj"].shape[0]
    N_l, E_l, T_l = N // n, E // n, T // n
    nodes, edges, tris = (slice(i * k, (i + 1) * k) for k in (N_l, E_l, T_l))
    feats_l = batch["features"][nodes].to(cd)
    h_l = feats_l @ dense["feat_proj"].to(cd)
    pos_l = (feats_l @ dense["pos_proj"].to(cd)).to(f32)
    h = all_gather(h_l, group)                                      # (N, h)
    pos = all_gather(pos_l, group)                                  # (N, 3)
    out_acc = _node_sums(dense, cfg, h, pos,
                         batch["edge_src"][edges].to(torch.int64),
                         batch["edge_dst"][edges].to(torch.int64),
                         batch["tri_kj"][tris].to(torch.int64) % E_l,   # locality clamp
                         batch["tri_ji"][tris].to(torch.int64) % E_l,
                         N)
    out_l = reduce_scatter(out_acc, group)                          # (N_l, h)
    return mlp_apply(dense["out_mlp"], out_l.to(cd), compute_dtype=cd).to(f32)


def clamp_remap(batch, n_shards: int):
    """(tri_kj, tri_ji) int64 of ``batch`` as the sharded forward over
    ``n_shards`` ranges uses them, in global edge indices: the triplets of
    range r taken into edge range r (r·E_l + kj % E_l, r·E_l + ji % E_l).
    ``forward_flat`` on the batch with these equals the ranks' rows of
    ``forward_flat_sharded``, up to the order of the node sums."""
    E, T = batch["edge_src"].shape[0], batch["tri_kj"].shape[0]
    E_l, T_l = E // n_shards, T // n_shards
    base = (torch.arange(T, device=batch["tri_kj"].device) // T_l) * E_l
    return (base + batch["tri_kj"].to(torch.int64) % E_l,
            base + batch["tri_ji"].to(torch.int64) % E_l)


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


def _seed_rows(batch, labels):
    """The node row of every seed: the first rows (``seed_slice``), the
    ``seed_idx`` rows, or every node."""
    if "seed_idx" in batch and "seed_slice" not in batch:
        return batch["seed_idx"].to(torch.int64)
    return torch.arange(labels.shape[0], device=labels.device)


def _ce_terms(seed_logits, labels):
    """(per-seed cross-entropy, per-seed hit as f32)."""
    lse = torch.logsumexp(seed_logits, dim=-1)
    gold = torch.gather(seed_logits, 1, labels[:, None])[:, 0]
    with torch.no_grad():
        hit = (torch.argmax(seed_logits, dim=-1) == labels).to(torch.float32)
    return lse - gold, hit


def _sharded_loss(params, batch, cfg: DimeNetConfig, rules: ShardingRules):
    """Graph mode on a mesh: the global mean over the seeds of the
    cross-entropy, and the accuracy. Each rank sums the terms of the seeds
    in its node range (a mask, so the shapes hold no data and the meta
    device runs it); one all-reduce of (sum, hits), whose backward passes
    the cotangent through, makes both global on every rank."""
    logits_l = forward_flat_sharded(params, batch, cfg, rules)      # (N_l, C)
    group, i, _ = _shard_group(batch, rules)
    labels = batch["labels"].to(torch.int64)
    rows = _seed_rows(batch, labels)
    n_l = logits_l.shape[0]
    lo = i * n_l
    mine = ((rows >= lo) & (rows < lo + n_l)).to(torch.float32)
    terms, hit = _ce_terms(logits_l[(rows - lo).clamp(0, n_l - 1)], labels)
    sums = all_reduce(torch.stack([torch.sum(terms * mine), torch.sum(hit * mine)]),
                      group, backward="identity")
    n_seeds = labels.shape[0]
    return sums[0] / n_seeds, dict(accuracy=(sums[1] / n_seeds).detach(), touched={})


def train_loss(params, batch, cfg: DimeNetConfig,
               rules: ShardingRules = NO_SHARDING):
    """(loss, aux). Molecule mode: the energies' mean squared error, the
    species rows touched; on a mesh that carries a group, each rank's
    molecules are its data shard of the batch, and the loss, the error and
    the touched rows are the global batch's (``models.embedding.
    ShardedLookup``; the 95-row species table is replicated). Graph mode: the seeds' cross-entropy and
    accuracy; on a mesh where ``_use_sharded`` holds, through
    ``forward_flat_sharded`` on this rank's ranges (``_sharded_loss``),
    each rank then holding the same global loss. The gradient rule there:
    a replicated parameter's gradient is the sum of the ranks' gradients
    (``train.steps.make_train_step(grad_groups=...)`` sums them in one
    all-reduce)."""
    if cfg.d_feat == 0:
        lookup = table_lookup(rules)
        if lookup.owned(cfg.n_species)[1] != cfg.n_species:
            raise ValueError(f"the {cfg.n_species}-row species table is read whole; "
                             f"it cannot shard over {rules.mesh!r}")
        energy = _molecules(params, batch, cfg)                     # (B,)
        err = energy - batch["energy"]
        with torch.no_grad():
            abs_err = torch.abs(err)
        loss, mae = lookup.means(torch.square(err), abs_err)
        with torch.no_grad():
            touched = lookup.touched(cfg.n_species, lookup.ids(batch["species"]))
        return loss, dict(mae=mae.detach(), touched={"species": touched})
    if _use_sharded(batch, cfg, rules):
        return _sharded_loss(params, batch, cfg, rules)
    logits = forward_flat(params, batch, cfg)                       # (N, C)
    labels = batch["labels"].to(torch.int64)
    if "seed_slice" in batch:
        seed_logits = logits[: labels.shape[0]]
    elif "seed_idx" in batch:
        seed_logits = logits[batch["seed_idx"].to(torch.int64)]
    else:
        seed_logits = logits
    terms, hit = _ce_terms(seed_logits, labels)
    return torch.mean(terms), dict(accuracy=torch.mean(hit), touched={})


def serve(params, batch, cfg: DimeNetConfig,
          rules: ShardingRules = NO_SHARDING) -> torch.Tensor:
    """Molecule mode: energies (B,); graph mode: per-node outputs (N, C).
    Without gradients; the mesh is ignored, as the reference's serving
    does."""
    del rules
    with torch.no_grad():
        if cfg.d_feat == 0:
            return _molecules(params, {k: batch[k] for k in _MOLECULE_KEYS}, cfg)
        return forward_flat(params, batch, cfg)
