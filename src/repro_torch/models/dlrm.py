"""DLRM (Naumov et al., arXiv:1906.00091) — the paper's own model family, in
PyTorch.

dlrm-rm2 config: 13 dense, 26 sparse fields, dim 64, bottom MLP 13-512-256-64,
top MLP 512-512-256-1, dot-product interaction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..dist.sharding import NO_SHARDING, ShardingRules
from ..kernels.dot_interaction import dot_interaction as dot_interaction_op
from ..kernels.embedding_bag import embedding_bag_fields
from ..train.state import TrackedSpec, TrainState
from ..tree import tree_map
from .embedding import (
    WHOLE,
    bce_terms,
    bce_with_logits,
    init_tables,
    lookup_fields,
    mlp_apply,
    mlp_init,
    table_lookup,
    table_specs,
    touched_masks,
)


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    vocab_sizes: Tuple[int, ...] = ()
    embed_dim: int = 64
    bot_mlp: Tuple[int, ...] = (512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 512, 256, 1)
    multi_hot: int = 1
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    @property
    def n_interact(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2

    @property
    def table_rows(self) -> int:
        return sum(self.vocab_sizes)


def init_params(gen: torch.Generator, cfg: DLRMConfig):
    """Random params on ``gen``'s device: tables, then bottom MLP, then top."""
    tables = init_tables(gen, cfg.vocab_sizes, cfg.embed_dim)
    dense = dict(
        bot=mlp_init(gen, (cfg.n_dense,) + cfg.bot_mlp),
        top=mlp_init(gen, (cfg.embed_dim + cfg.n_interact,) + cfg.top_mlp),
    )
    return dict(tables=tables, dense=dense)


def tracked_specs(cfg: DLRMConfig) -> Dict[str, TrackedSpec]:
    return table_specs(cfg.vocab_sizes, cfg.embed_dim)


def dense_flops(cfg: DLRMConfig, batch: int) -> float:
    """Analytic forward FLOPs of ``batch`` examples: the two MLPs' products
    and the dot interaction (the matmul-dominated terms)."""
    dims = (cfg.n_dense,) + cfg.bot_mlp
    f = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    Ft = cfg.n_sparse + 1
    f += 2 * Ft * Ft * cfg.embed_dim  # dot interaction
    dims = (cfg.embed_dim + cfg.n_interact,) + cfg.top_mlp
    f += sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    return float(f) * batch


def retrieval_flops(cfg: DLRMConfig, n_candidates: int) -> float:
    """A retrieval request's FLOPs: the whole forward a candidate."""
    return dense_flops(cfg, n_candidates)


def dot_interaction(feats: torch.Tensor) -> torch.Tensor:
    """feats (B, F, D) → pairwise dots ⟨f_i, f_j⟩ for i < j, in
    ``np.triu_indices`` order: (B, F(F-1)/2)."""
    z = torch.bmm(feats, feats.transpose(1, 2))
    iu, ju = np.triu_indices(feats.shape[1], k=1)
    return z[:, torch.from_numpy(iu).to(feats.device),
             torch.from_numpy(ju).to(feats.device)]


def _logits(dense_params, dense_x, emb, cfg: DLRMConfig,
            interact=dot_interaction) -> torch.Tensor:
    """``emb`` (B, F, D) is the looked-up (bag-summed) sparse features;
    ``interact`` maps the (B, F+1, D) features to their pairwise dots."""
    cd = cfg.compute_dtype
    bot = mlp_apply(dense_params["bot"], dense_x, final_act=True, compute_dtype=cd)
    feats = torch.cat([bot[:, None, :], emb.to(cd)], dim=1)
    inter = interact(feats)
    top_in = torch.cat([bot, inter], dim=-1)
    out = mlp_apply(dense_params["top"], top_in, compute_dtype=cd)
    return out[..., 0].to(torch.float32)


def train_loss(params, batch, cfg: DLRMConfig):
    """The dense-gradient loss (the reference's generic-step path)."""
    emb = lookup_fields(params["tables"], batch["sparse_ids"])
    logits = _logits(params["dense"], batch["dense"], emb, cfg)
    loss = bce_with_logits(logits, batch["label"])
    acc = torch.mean(((logits > 0) == (batch["label"] > 0.5)).to(torch.float32))
    touched = touched_masks(cfg.vocab_sizes, batch["sparse_ids"])
    return loss, dict(accuracy=acc, touched=touched)


def serve(params, batch, cfg: DLRMConfig, bag=embedding_bag_fields,
          interact=dot_interaction_op) -> torch.Tensor:
    """Online/offline CTR scoring (the serve_p99 / serve_bulk cells): the
    sigmoid of the logits, without gradients. On a card the lookup is one
    ``embedding_bag`` kernel launch for all fields and the interaction one
    ``dot_interaction`` launch; ``bag`` (a multi-field op) and ``interact``
    swap in other versions of the two ops (the plain ones, to hold the
    kernels against them). The f32 dots are cast to the compute dtype,
    which is what the reference's einsum in that dtype yields."""
    with torch.no_grad():
        emb = lookup_fields(params["tables"], batch["sparse_ids"], bag=bag)
        logits = _logits(params["dense"], batch["dense"], emb, cfg,
                         interact=lambda f: interact(f).to(f.dtype))
        return torch.sigmoid(logits)


def serve_retrieval(params, batch, cfg: DLRMConfig,
                    bag=embedding_bag_fields) -> torch.Tensor:
    """The retrieval_cand cell: one user context (batch 1) scored against C
    candidate items, which stand in for sparse field 0; → (C,) f32
    probabilities, without gradients. The user's bottom MLP and its 26-field
    lookup (one ``bag`` call: one ``embedding_bag`` launch on a card; field 0
    is looked up and dropped) are computed once; the candidates are gathered
    from ``emb_0``. The top MLP's input is the reference's layout, not
    ``serve``'s: ``[bot, cand·fixedᵀ, triu(fixed·fixedᵀ, k=1)]`` with
    ``fixed = [bot, e_1 … e_{F-1}]``; both products are plain matmuls, as
    in the reference."""
    cd = cfg.compute_dtype
    with torch.no_grad():
        cand_ids = batch["candidate_ids"].to(torch.int64)          # (C,)
        C = cand_ids.shape[0]
        bot = mlp_apply(params["dense"]["bot"], batch["dense"], final_act=True,
                        compute_dtype=cd)                           # (1, D)
        emb = lookup_fields(params["tables"], batch["sparse_ids"], bag=bag)
        cand = params["tables"]["emb_0"].index_select(0, cand_ids).to(cd)
        fixed = torch.cat([bot[:, None, :], emb[:, 1:, :].to(cd)], dim=1)[0]
        iu, ju = np.triu_indices(fixed.shape[0], k=1)
        fixed_dots = (fixed @ fixed.T)[torch.from_numpy(iu).to(fixed.device),
                                       torch.from_numpy(ju).to(fixed.device)]
        cand_dots = cand @ fixed.T                                  # (C, F)
        top_in = torch.cat([bot[0].expand(C, bot.shape[-1]), cand_dots,
                            fixed_dots.expand(C, fixed_dots.shape[0])], dim=-1)
        out = mlp_apply(params["dense"]["top"], top_in, compute_dtype=cd)
        return torch.sigmoid(out[..., 0].to(torch.float32))


def make_sparse_train_step(cfg: DLRMConfig, dense_opt, lr: float = 0.01,
                           eps: float = 1e-8, rules: ShardingRules = NO_SHARDING):
    """Sparse embedding update with exact row-wise-AdaGrad semantics.

    Gradients are taken w.r.t. the *gathered vectors* (B, F, H, D), not the
    tables; per field the per-id gradients are dedup-aggregated (sort +
    ``index_add_``) and applied to the touched rows only, so memory traffic
    scales with touched rows, not table rows. The tables and their
    accumulators are updated IN PLACE (a full-width table is gigabytes);
    the dense params and the touched masks are new tensors each step.

    On a rank of a mesh (``rules`` over a mesh that carries a group; see
    ``models.embedding.ShardedLookup``) the vectors come from the tables'
    owners in f32, the loss and accuracy are the global batch's, and the
    vectors' cotangents are gathered over the ``data`` axis: a row's owner
    aggregates every data shard's gradient for it in the global batch's id
    order and updates the row once (the accumulator adds ``mean(g²)`` of
    the summed gradient, so two half-updates would not be one). The dense
    gradients are summed over ``data``.
    """
    from ..optim.optimizers import apply_updates
    from ..train.steps import sum_grads

    F = cfg.n_sparse
    lookup = table_lookup(rules)
    names = [f"emb_{i}" for i in range(F)]

    def train_step(state: TrainState, batch):
        tables = state.params["tables"]
        ids = lookup.ids(batch["sparse_ids"])                 # (B,F,H)
        vectors = lookup.rows([tables[n] for n in names], ids,
                              cfg.vocab_sizes)                # (B,F,H,D)
        vectors.requires_grad_(True)
        leaves = []

        def track(p):
            q = p.detach().requires_grad_(True)
            leaves.append(q)
            return q

        dense_p = tree_map(track, state.params["dense"])
        logits = _logits(dense_p, batch["dense"], vectors.sum(dim=2), cfg)
        with torch.no_grad():
            hits = ((logits > 0) == (batch["label"] > 0.5)).to(torch.float32)
        loss, acc_m = lookup.means(bce_terms(logits, batch["label"]), hits)
        *g_leaves, g_vec = torch.autograd.grad(loss, leaves + [vectors])
        it = iter(g_leaves)
        g_dense = tree_map(lambda _: next(it), state.params["dense"])

        with torch.no_grad():
            if lookup is not WHOLE:
                g_dense = sum_grads(g_dense, lookup.data)
            d_upd, d_state = dense_opt.update(
                g_dense, state.opt_state["dense"], state.params["dense"])
            new_dense = apply_updates(state.params["dense"], d_upd)

            g_every = lookup.cotangents(g_vec, ids)           # every id's
            accs = state.opt_state["tables"]
            touched = dict(state.touched)
            for f, name in enumerate(names):
                lo, held = lookup.owned(cfg.vocab_sizes[f])
                lo = lo if held < cfg.vocab_sizes[f] else None
                idf = ids.every[:, f, :].reshape(-1)          # (B·H,)
                adagrad_rows(tables[name], accs[name], idf,
                             g_every[:, f].reshape(idf.shape[0], -1), lo, lr, eps)
                touched[name] = touched[name] | lookup.touched(
                    cfg.vocab_sizes[f], ids.field(f))

        new_state = TrainState(
            step=state.step + 1,
            params=dict(tables=tables, dense=new_dense),
            opt_state=dict(tables=accs, dense=d_state),
            touched=touched, rng=state.rng)
        return new_state, dict(loss=loss.detach(), accuracy=acc_m.detach())

    return train_step


def adagrad_rows(table: torch.Tensor, acc: torch.Tensor, ids: torch.Tensor,
                 g: torch.Tensor, lo: Optional[int], lr: float, eps: float) -> None:
    """Row-wise AdaGrad, in place, on ``table`` and ``acc``: each id's rows
    of ``g`` (N, D) summed per distinct id in sorted order (sort, then
    ``index_add_``: the reference's segment sum), then one update a row.
    With ``lo`` the two hold rows ``[lo, lo + len(table))`` of the table
    and only the ids in that range update them. The
    shapes of the update depend on the ids, so on the meta device (the dry
    run, which counts collectives: the update issues none) it does
    nothing."""
    if g.is_meta:
        return
    ids_s, order = torch.sort(ids)
    first = torch.ones_like(ids_s, dtype=torch.bool)
    first[1:] = ids_s[1:] != ids_s[:-1]
    seg = torch.cumsum(first, dim=0) - 1
    write_ids = ids_s[first]                                  # unique, sorted
    g_rows = torch.zeros((write_ids.shape[0], g.shape[1]), dtype=g.dtype,
                         device=g.device)
    g_rows.index_add_(0, seg, g[order])
    if lo is not None:
        mine = (write_ids >= lo) & (write_ids < lo + table.shape[0])
        write_ids, g_rows = write_ids[mine] - lo, g_rows[mine]
    new_acc = acc[write_ids] + torch.mean(torch.square(g_rows), dim=-1)
    upd = -lr * g_rows / (torch.sqrt(new_acc)[:, None] + eps)
    table.index_add_(0, write_ids, upd.to(table.dtype))
    acc[write_ids] = new_acc
