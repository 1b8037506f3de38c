"""BERT4Rec (arXiv:1904.06690), in PyTorch: a bidirectional transformer over
item sequences with the masked-item (Cloze) objective. Config: dim 64, 2
blocks, 2 heads, seq 200; the output layer tied to the item embedding table.

The parameter tree is the reference's (``src/repro/models/bert4rec.py``):
the per-block weights stacked on a leading ``n_blocks`` axis under
``dense/blocks``, and ``tables/item_0``, ``dense/pos_emb``,
``dense/out_bias``, so checkpoints and snapshots keep the same paths in both
packages. Training attends through ``models.layers.chunked_attention``, as
the reference does; ``serve`` runs without gradients and attends through the
``flash_attention`` kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import torch

from ..kernels.flash_attention import flash_attention
from ..train.state import TrackedSpec
from .embedding import init_tables, table_specs, take
from .layers import chunked_attention, dense_init, gelu, layernorm


@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    name: str = "bert4rec"
    n_items: int = 1_000_000
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    d_ff: int = 256
    compute_dtype: torch.dtype = torch.bfloat16
    # serve runs a batch in slices of at most this many rows (None: whole);
    # each row is scored independently, so slicing bounds the activations'
    # memory without changing any row's scores
    serve_slice_rows: Optional[int] = None


def init_params(gen: torch.Generator, cfg: Bert4RecConfig):
    """Random params on ``gen``'s device: the item table, then the blocks,
    then the position embeddings."""
    d, H = cfg.embed_dim, cfg.n_heads
    Dh = d // H
    tables = init_tables(gen, (cfg.n_items,), d, prefix="item")

    def block_init():
        return dict(
            wq=dense_init(gen, (d, H, Dh)), wk=dense_init(gen, (d, H, Dh)),
            wv=dense_init(gen, (d, H, Dh)), wo=dense_init(gen, (H, Dh, d)),
            w1=dense_init(gen, (d, cfg.d_ff)), w2=dense_init(gen, (cfg.d_ff, d)))

    per_block = [block_init() for _ in range(cfg.n_blocks)]
    blocks = {k: torch.stack([b[k] for b in per_block]) for k in per_block[0]}
    dev = gen.device
    for name, fill in (("ln1_g", 1.0), ("ln1_b", 0.0), ("ln2_g", 1.0), ("ln2_b", 0.0)):
        blocks[name] = torch.full((cfg.n_blocks, d), fill, device=dev)
    dense = dict(
        blocks=blocks,
        pos_emb=dense_init(gen, (cfg.seq_len, d), scale=0.02),
        out_bias=torch.zeros((cfg.n_items,), device=dev),
        final_ln_g=torch.ones((d,), device=dev),
        final_ln_b=torch.zeros((d,), device=dev),
    )
    return dict(tables=tables, dense=dense)


def tracked_specs(cfg: Bert4RecConfig) -> Dict[str, TrackedSpec]:
    return table_specs((cfg.n_items,), cfg.embed_dim, prefix="item")


def _project(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one (B*S, d) x (d, H*Dh) product:
    the result is contiguous, unit stride along the head dim."""
    B, S, d = h.shape
    _, H, Dh = w.shape
    return (h.reshape(B * S, d) @ w.reshape(d, H * Dh)).view(B, S, H, Dh)


def encode(params, items: torch.Tensor, cfg: Bert4RecConfig,
           attention: Callable = chunked_attention) -> torch.Tensor:
    """items (B, S) → hidden (B, S, D) in the compute dtype; bidirectional
    attention through ``attention(q, k, v, causal=False)``."""
    cd = cfg.compute_dtype
    S = items.shape[1]
    x = take(params["tables"]["item_0"], items).to(cd)
    x = x + params["dense"]["pos_emb"][None, :S].to(cd)
    blocks = params["dense"]["blocks"]
    for i in range(cfg.n_blocks):
        bp = {k: v[i] for k, v in blocks.items()}
        h = layernorm(x, bp["ln1_g"], bp["ln1_b"])
        q = _project(h, bp["wq"].to(cd))
        k = _project(h, bp["wk"].to(cd))
        v = _project(h, bp["wv"].to(cd))
        a = attention(q, k, v, causal=False)
        B, _, H, Dh = a.shape
        x = x + a.reshape(B, S, H * Dh) @ bp["wo"].to(cd).reshape(H * Dh, -1)
        h = layernorm(x, bp["ln2_g"], bp["ln2_b"])
        x = x + gelu(h @ bp["w1"].to(cd)) @ bp["w2"].to(cd)
    return layernorm(x, params["dense"]["final_ln_g"], params["dense"]["final_ln_b"])


# the reference's chunking for bert4rec: one 200 x 200 chunk
_train_attention = functools.partial(chunked_attention, q_chunk=200, k_chunk=200)


def train_loss(params, batch, cfg: Bert4RecConfig):
    """Cloze loss at masked positions, sampled softmax over the shared
    negatives (tied item weights). → (loss, dict(accuracy, touched))."""
    items, labels, mask = batch["items"], batch["labels"], batch["mask"]
    negs = batch["neg_ids"].to(torch.int64)              # (N,) shared negatives
    h = encode(params, items, cfg, _train_attention).to(torch.float32)   # (B,S,D)
    table, bias = params["tables"]["item_0"], params["dense"]["out_bias"]
    lab = labels.to(torch.int64)
    e_pos = take(table, lab).to(torch.float32)          # (B,S,D)
    e_neg = take(table, negs).to(torch.float32)         # (N,D)
    b_pos = take(bias, lab)
    b_neg = take(bias, negs)
    pos = torch.einsum("bsd,bsd->bs", h, e_pos) + b_pos
    neg = torch.einsum("bsd,nd->bsn", h, e_neg) + b_neg
    logits = torch.cat([pos[..., None], neg], dim=-1)    # (B,S,1+N)
    ce = torch.logsumexp(logits, dim=-1) - logits[..., 0]
    w = mask.to(torch.float32)
    denom = torch.clamp(torch.sum(w), min=1.0)
    loss = torch.sum(ce * w) / denom
    with torch.no_grad():
        acc = torch.sum((torch.argmax(logits, dim=-1) == 0) * w) / denom
        ids = torch.cat([items.reshape(-1).to(torch.int64), lab.reshape(-1), negs])
        touched = torch.zeros((cfg.n_items,), dtype=torch.bool, device=items.device)
        touched[ids] = True
    return loss, dict(accuracy=acc, touched={"item_0": touched})


def _scores(params, items, cand, cfg, attention):
    h = encode(params, items, cfg, attention)[:, -1].to(torch.float32)   # (B,D)
    e = take(params["tables"]["item_0"], cand).to(torch.float32)       # (B,C,D)
    b = take(params["dense"]["out_bias"], cand)
    return torch.einsum("bd,bcd->bc", h, e) + b


def serve(params, batch, cfg: Bert4RecConfig,
          attention: Callable = flash_attention) -> torch.Tensor:
    """Next-item scores (B, C) f32 for each example's candidates at the last
    position, without gradients. On a card both blocks attend through the
    ``flash_attention`` kernel (two launches per forward); ``attention``
    swaps in another version (the plain one, to hold the kernel against it).
    A batch larger than ``cfg.serve_slice_rows`` runs in slices of that
    many rows."""
    items, cand = batch["items"], batch["candidate_ids"]
    rows = cfg.serve_slice_rows or items.shape[0]
    with torch.no_grad():
        if items.shape[0] <= rows:
            return _scores(params, items, cand, cfg, attention)
        return torch.cat([_scores(params, items[i:i + rows], cand[i:i + rows],
                                  cfg, attention)
                          for i in range(0, items.shape[0], rows)])


def serve_retrieval(params, batch, cfg: Bert4RecConfig,
                    attention: Callable = flash_attention) -> torch.Tensor:
    """The retrieval_cand cell: one user's sequence (1, S) scored against C
    candidate items; → (C,) f32, without gradients. The encode attends as
    ``serve``'s does (two ``flash_attention`` launches on a card); the last
    position's state then meets every candidate's embedding in one f32
    product, plus the candidates' output bias."""
    with torch.no_grad():
        h = encode(params, batch["items"], cfg, attention)[0, -1].to(torch.float32)
        cand = batch["candidate_ids"]                                  # (C,)
        e = take(params["tables"]["item_0"], cand).to(torch.float32)   # (C, D)
        return e @ h + take(params["dense"]["out_bias"], cand)
