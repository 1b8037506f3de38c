"""xDeepFM (arXiv:1803.05170), in PyTorch: linear + CIN (compressed
interaction network) + deep MLP. Config: 39 sparse fields, dim 10, CIN
200-200-200, MLP 400-400.

The parameter tree is the reference's (``src/repro/models/xdeepfm.py``):
tables ``emb_*`` (dim 10) and ``lin_*`` (dim 1, the linear term's
weights), and under ``dense`` the list ``cin`` of (H_k, H_{k-1}, F)
weights, ``cin_out``, the ``deep`` MLP and a 0-d ``bias``, so the
snapshot's dense keys are the reference's (``params['cin'][0]``,
``params['bias']``).

Serving looks up both table families through the ``embedding_bag`` kernel
on a card: two launches a forward, one for the 39 ``emb_*`` fields and
one for the 39 ``lin_*`` fields. The kernel has no backward, so
``train_loss`` looks up through ``take_fields`` (differentiable gathers,
the same numbers), or on a mesh through ``models.embedding.ShardedLookup``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..dist.sharding import NO_SHARDING, ShardingRules
from ..kernels.embedding_bag import embedding_bag_fields
from ..train.state import TrackedSpec
from .embedding import (
    bce_terms,
    init_tables,
    lookup_fields,
    mlp_apply,
    mlp_init,
    table_lookup,
    table_specs,
)
from .layers import dense_init

# serve_retrieval scores candidates in chunks of this many, as the
# reference does, and only whole chunks: C // RETRIEVAL_CHUNK of them
RETRIEVAL_CHUNK = 8192


@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    vocab_sizes: Tuple[int, ...] = ()
    embed_dim: int = 10
    cin_layers: Tuple[int, ...] = (200, 200, 200)
    mlp: Tuple[int, ...] = (400, 400)
    multi_hot: int = 1
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)


def init_params(gen: torch.Generator, cfg: XDeepFMConfig):
    """Random params on ``gen``'s device: the ``emb_*`` tables, the
    ``lin_*`` tables, the CIN weights, ``cin_out``, the deep MLP; the bias
    is 0."""
    F = cfg.n_sparse
    tables = init_tables(gen, cfg.vocab_sizes, cfg.embed_dim)
    tables.update(init_tables(gen, cfg.vocab_sizes, 1, prefix="lin"))
    cin_ws = []
    h_prev = F
    for h in cfg.cin_layers:
        cin_ws.append(dense_init(gen, (h, h_prev, F)))
        h_prev = h
    dense = dict(
        cin=cin_ws,
        cin_out=dense_init(gen, (sum(cfg.cin_layers), 1)),
        deep=mlp_init(gen, (F * cfg.embed_dim,) + cfg.mlp + (1,)),
        bias=torch.zeros((), device=gen.device),
    )
    return dict(tables=tables, dense=dense)


def tracked_specs(cfg: XDeepFMConfig) -> Dict[str, TrackedSpec]:
    specs = table_specs(cfg.vocab_sizes, cfg.embed_dim)
    specs.update(table_specs(cfg.vocab_sizes, 1, prefix="lin"))
    return specs


def dense_flops(cfg: XDeepFMConfig, batch: int) -> float:
    """Analytic forward FLOPs of ``batch`` examples: the CIN's outer
    products and compressions, and the MLP."""
    F, D = cfg.n_sparse, cfg.embed_dim
    f = 0.0
    h_prev = F
    for h in cfg.cin_layers:
        f += 2 * h_prev * F * D          # outer product
        f += 2 * h * h_prev * F * D      # compression
        h_prev = h
    dims = (F * D,) + cfg.mlp + (1,)
    f += sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    return float(f) * batch


def retrieval_flops(cfg: XDeepFMConfig, n_candidates: int) -> float:
    """A retrieval request's FLOPs: the whole forward a candidate."""
    return dense_flops(cfg, n_candidates)


def cin(x0: torch.Tensor, weights, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Compressed Interaction Network. x0 (B, F, D) → (B, sum(H_k)).

    Layer k forms z = the outer feature-map product of x_{k-1} and x0,
    (H_{k-1}, F, B, D) in the compute dtype, compresses it by w (H_k,
    H_{k-1}, F) into x_k (H_k, B, D), and pools x_k over D. The maps are
    held field-major ((H, B, D), not the reference's (B, H, D)), so the
    compression is one (H_k, H_{k-1} F) x (H_{k-1} F, B D) product. Each z
    is freed before the next is formed (at serve_bulk's 262,144 rows, z is
    41 GB in bf16)."""
    cd = compute_dtype
    x0t = x0.to(cd).permute(1, 0, 2).contiguous()           # (F, B, D)
    F, B, D = x0t.shape
    xk = x0t
    pooled = []
    for w in weights:
        h = xk.shape[0]
        z = xk[:, None] * x0t[None]                          # (H, F, B, D)
        xk = (w.to(cd).reshape(w.shape[0], h * F) @ z.view(h * F, B * D)).view(-1, B, D)
        del z
        pooled.append(torch.sum(xk, dim=-1))                 # (H_k, B)
    return torch.cat(pooled, dim=0).T


def _logits_of(params, emb: torch.Tensor, lin: torch.Tensor,
               cfg: XDeepFMConfig) -> torch.Tensor:
    """Logits from the looked-up features: ``emb`` (B, F, D) and ``lin``
    (B, F, 1), both bf16 as the lookup casts them."""
    cd = cfg.compute_dtype
    emb = emb.to(cd)
    linear_term = torch.sum(lin[..., 0].to(torch.float32), dim=-1)
    cin_feats = cin(emb, params["dense"]["cin"], cd)
    cin_term = (cin_feats @ params["dense"]["cin_out"].to(cd))[..., 0]
    B = emb.shape[0]
    deep_term = mlp_apply(params["dense"]["deep"], emb.reshape(B, -1),
                          compute_dtype=cd)[..., 0]
    return (linear_term + cin_term.to(torch.float32)
            + deep_term.to(torch.float32) + params["dense"]["bias"])


def _logits(params, sparse_ids, cfg: XDeepFMConfig, bag=embedding_bag_fields):
    emb = lookup_fields(params["tables"], sparse_ids, bag=bag)                # (B,F,D)
    lin = lookup_fields(params["tables"], sparse_ids, prefix="lin", bag=bag)  # (B,F,1)
    return _logits_of(params, emb, lin, cfg)


def train_loss(params, batch, cfg: XDeepFMConfig, rules: ShardingRules = NO_SHARDING):
    """BCE on the click label, the lookups through ``take_fields`` (on a
    mesh, ``ShardedLookup.fields``: one bf16 exchange a table family). →
    (loss, dict(accuracy, touched)) with both table families' touched
    rows (this rank's, on a mesh), loss and accuracy over the global
    batch."""
    lookup = table_lookup(rules)
    ids = lookup.ids(batch["sparse_ids"])
    tables = params["tables"]
    feats = [lookup.fields([tables[f"{prefix}_{f}"] for f in range(cfg.n_sparse)], ids,
                           cfg.vocab_sizes) for prefix in ("emb", "lin")]
    logits = _logits_of(params, *feats, cfg)
    with torch.no_grad():
        hits = ((logits > 0) == (batch["label"] > 0.5)).to(torch.float32)
    loss, acc = lookup.means(bce_terms(logits, batch["label"]), hits)
    with torch.no_grad():
        touched = {f"{prefix}_{f}": lookup.touched(v, ids.field(f))
                   for prefix in ("emb", "lin") for f, v in enumerate(cfg.vocab_sizes)}
    return loss, dict(accuracy=acc.detach(), touched=touched)


def serve(params, batch, cfg: XDeepFMConfig, bag=embedding_bag_fields) -> torch.Tensor:
    """Click probabilities (B,) f32, without gradients. On a card the
    lookups are two ``embedding_bag`` launches; ``bag`` swaps in another
    multi-field op (the plain one, to hold the kernel against it)."""
    with torch.no_grad():
        return torch.sigmoid(_logits(params, batch["sparse_ids"], cfg, bag=bag))


def n_retrieval_scores(n_candidates: int) -> int:
    """How many candidates ``serve_retrieval`` scores: whole chunks only,
    and at least one chunk (of all candidates, when fewer than a chunk)."""
    if n_candidates < RETRIEVAL_CHUNK:
        return n_candidates
    return (n_candidates // RETRIEVAL_CHUNK) * RETRIEVAL_CHUNK


def serve_retrieval(params, batch, cfg: XDeepFMConfig,
                    bag=embedding_bag_fields) -> torch.Tensor:
    """retrieval_cand: the single user row with each candidate on field 0;
    → (n,) f32 probabilities for the first ``n = n_retrieval_scores(C)``
    candidates (the reference scores whole chunks of 8,192 and drops the
    rest: 999,424 of 1,000,000). The user's 39 fields are looked up once,
    and the candidates' field-0 bags once (each one ``bag`` call per table
    family: four ``embedding_bag`` launches a request on a card); the CIN
    and the MLP run a chunk at a time, which bounds their intermediates."""
    sparse_ids = batch["sparse_ids"]                         # (1, F, H)
    n = n_retrieval_scores(batch["candidate_ids"].shape[0])
    cand = batch["candidate_ids"][:n]
    cand_ids = cand[:, None, None].expand(n, 1, sparse_ids.shape[2]).contiguous()
    tables = params["tables"]
    with torch.no_grad():
        user = (lookup_fields(tables, sparse_ids, bag=bag),
                lookup_fields(tables, sparse_ids, prefix="lin", bag=bag))
        cands = (bag([tables["emb_0"]], cand_ids), bag([tables["lin_0"]], cand_ids))
        scores = []
        for lo in range(0, n, RETRIEVAL_CHUNK):
            hi = min(lo + RETRIEVAL_CHUNK, n)
            feats = []
            for u, c in zip(user, cands):
                f = u.expand(hi - lo, -1, -1).clone()
                f[:, 0] = c[lo:hi, 0]
                feats.append(f)
            scores.append(_logits_of(params, *feats, cfg))
        return torch.sigmoid(torch.cat(scores))
