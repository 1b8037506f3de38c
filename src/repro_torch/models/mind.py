"""MIND (arXiv:1904.08030), in PyTorch: multi-interest network with dynamic
(capsule) routing. Config: dim 64, 4 interest capsules, 3 routing
iterations.

The parameter tree is the reference's (``src/repro/models/mind.py``):
``tables/item_0``, ``dense/bilinear`` and ``dense/routing_init`` — the
routing logits' starting point, shared across users, a parameter like the
others: it takes a gradient through the routing softmax, and the dense
AdaGrad updates it. The lookups are the reference's ``jnp.take``, here
``models.embedding.take`` (no kernel runs in the forward); the compute is
in ``compute_dtype`` up to the bilinear map, then f32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..dist.sharding import NO_SHARDING, ShardingRules
from ..train.state import TrackedSpec
from .embedding import init_tables, table_lookup, table_specs, take
from .layers import dense_init


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    n_items: int = 1_000_000
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    label_aware_pow: float = 2.0
    compute_dtype: torch.dtype = torch.bfloat16


def init_params(gen: torch.Generator, cfg: MINDConfig):
    """Random params on ``gen``'s device: the item table, the bilinear map,
    then the routing init (normal times 0.1)."""
    tables = init_tables(gen, (cfg.n_items,), cfg.embed_dim, prefix="item")
    dense = dict(
        bilinear=dense_init(gen, (cfg.embed_dim, cfg.embed_dim)),
        routing_init=torch.randn((cfg.hist_len, cfg.n_interests), generator=gen,
                                 device=gen.device) * 0.1,
    )
    return dict(tables=tables, dense=dense)


def tracked_specs(cfg: MINDConfig) -> Dict[str, TrackedSpec]:
    return table_specs((cfg.n_items,), cfg.embed_dim, prefix="item")


def dense_flops(cfg: MINDConfig, batch: int) -> float:
    """Analytic forward FLOPs of ``batch`` examples: the history's
    projection and the capsule routing iterations."""
    T, D, K = cfg.hist_len, cfg.embed_dim, cfg.n_interests
    f = 2 * T * D * D + cfg.capsule_iters * (3 * 2 * T * K * D)
    return float(f) * batch


def retrieval_flops(cfg: MINDConfig, n_candidates: int) -> float:
    """A retrieval request's FLOPs: the user's interests once, then each
    candidate against each interest."""
    return dense_flops(cfg, 1) + 2.0 * n_candidates * cfg.embed_dim * cfg.n_interests


def squash(s: torch.Tensor) -> torch.Tensor:
    n2 = torch.sum(torch.square(s), dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * s / torch.sqrt(n2 + 1e-9)


def interests(params, hist: torch.Tensor, cfg: MINDConfig,
              emb: torch.Tensor = None) -> torch.Tensor:
    """hist (B, T) item ids (0 = pad) → (B, K, D) f32 interest capsules.

    ``capsule_iters`` routing iterations; the result is the last one's
    capsules. The reference also updates the logits after the last
    iteration and drops them: that update is left out here, which changes
    no output and no gradient. Pad positions (``hist == 0``) get zero
    weight after the softmax over K. ``emb``: the history's rows, when the
    caller looked them up (``train_loss`` on a mesh)."""
    cd = cfg.compute_dtype
    if emb is None:
        emb = take(params["tables"]["item_0"], hist)
    emb = emb.to(cd)                                               # (B,T,D)
    valid = (hist > 0).to(torch.float32)                           # (B,T)
    e_hat = (emb @ params["dense"]["bilinear"].to(cd)).to(torch.float32)
    b = params["dense"]["routing_init"][None].expand(
        hist.shape[0], cfg.hist_len, cfg.n_interests).to(torch.float32)
    for i in range(cfg.capsule_iters):
        w = torch.softmax(b, dim=-1) * valid[..., None]            # (B,T,K)
        v = squash(torch.einsum("btk,btd->bkd", w, e_hat))         # (B,K,D)
        if i + 1 < cfg.capsule_iters:
            b = b + torch.einsum("bkd,btd->btk", v, e_hat)
    return v


def _label_aware_scores(v: torch.Tensor, target_emb: torch.Tensor,
                        pow_: float) -> torch.Tensor:
    """Label-aware attention over interests: (B,K,D) x (B,D) → (B,)."""
    att = torch.einsum("bkd,bd->bk", v, target_emb)
    w = torch.softmax(torch.pow(torch.abs(att) + 1e-9, pow_) * torch.sign(att), dim=-1)
    user = torch.einsum("bk,bkd->bd", w, v)
    return torch.einsum("bd,bd->b", user, target_emb)


def train_loss(params, batch, cfg: MINDConfig, rules: ShardingRules = NO_SHARDING):
    """Sampled-softmax over (target, shared negatives). → (loss,
    dict(accuracy, touched)), over the global batch; on a mesh the item
    rows come through ``models.embedding.ShardedLookup`` (the negatives
    are the same on every rank) and the mask holds this rank's rows."""
    lookup = table_lookup(rules)
    hist, target, negs = batch["hist"], batch["target"], batch["neg_ids"]
    h_ids, t_ids, n_ids = lookup.ids(hist), lookup.ids(target), lookup.ids(negs, True)
    table, n = params["tables"]["item_0"], cfg.n_items
    v = interests(params, hist, cfg, emb=lookup.take(table, h_ids, n))  # (B,K,D)
    e_t = lookup.take(table, t_ids, n).to(torch.float32)                # (B,D)
    e_n = lookup.take(table, n_ids, n).to(torch.float32)                # (N,D)
    pos = _label_aware_scores(v, e_t, cfg.label_aware_pow)              # (B,)
    # negatives scored against the best-matching interest (serving semantics)
    neg = torch.amax(torch.einsum("bkd,nd->bkn", v, e_n), dim=1)        # (B,N)
    logits = torch.cat([pos[:, None], neg], dim=-1)
    with torch.no_grad():
        hits = (torch.argmax(logits, dim=-1) == 0).to(torch.float32)
    loss, acc = lookup.means(torch.logsumexp(logits, dim=-1) - logits[:, 0], hits)
    with torch.no_grad():
        touched = lookup.touched(n, h_ids, t_ids, n_ids)
    return loss, dict(accuracy=acc.detach(), touched={"item_0": touched})


def serve(params, batch, cfg: MINDConfig) -> torch.Tensor:
    """Score (user hist, target) pairs — the serve_p99 / serve_bulk cells:
    (B,) f32 scores, without gradients."""
    with torch.no_grad():
        v = interests(params, batch["hist"], cfg)
        e_t = take(params["tables"]["item_0"], batch["target"]).to(torch.float32)
        return _label_aware_scores(v, e_t, cfg.label_aware_pow)


def serve_retrieval(params, batch, cfg: MINDConfig) -> torch.Tensor:
    """One user's interests vs C candidates: the max over interests of
    the f32 dot, → (C,), without gradients."""
    with torch.no_grad():
        v = interests(params, batch["hist"], cfg)[0]                    # (K,D)
        cand = take(params["tables"]["item_0"],
                    batch["candidate_ids"]).to(torch.float32)           # (C,D)
        return torch.amax(cand @ v.T, dim=-1)
