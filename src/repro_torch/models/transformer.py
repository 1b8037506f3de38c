"""Transformer LM family, in PyTorch: nemotron-4-15b (squared-ReLU, no GLU,
no bias), qwen2-0.5b (GQA, SwiGLU, QKV bias), the mixtures of experts
olmoe-1b-7b and dbrx-132b, and minicpm3-4b (Multi-head Latent Attention).

The parameter tree is the reference's (``src/repro/models/transformer.py``):
f32 masters, every layer leaf stacked ``(L, ...)`` under ``dense/blocks``,
the token embedding the one tracked table (``tables/tok_emb``); compute in
``compute_dtype`` (bf16).

  * Training: a loop over the layers, each recomputed in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``) when
    ``remat``; attention through ``models.layers.chunked_attention``, the
    reference's own, which autograd differentiates; the cross-entropy over
    512-position chunks, each checkpointed, so the (B, S, V) logits are
    never formed.
  * Prefill: the full forward with ``attention`` — by default
    ``flash_attention``: on the card its bf16 tensor-core kernel, causal,
    with GQA; ``chunked_attention`` is its plain version.
  * Decode: the reference's plain ``decode_attention`` against the cache
    (MLA: the absorbed decode against the latent cache). The cache is
    written in place (the reference updates it functionally; the values are
    the same), so a 51.5 GB cache is never copied.
  * MoE layers (``models.layers.moe_ffn``) return each layer's
    expert-touched mask, stacked (L, E) by ``forward``: it marks the expert
    blocks (``moe_w_up``, ``moe_w_gate``, ``moe_w_down``, one unit a
    (layer, expert)) that the next incremental checkpoint writes; their
    auxiliary load-balancing losses are summed into the training loss.
  * On a rank of a (data, model) mesh that carries a process group,
    ``train_loss(..., sharded=True)`` runs the tensor- and
    sequence-parallel step (``dist.tensor_parallel``): the rank's heads,
    ff columns, experts and vocabulary columns, its data shard of the
    batch, the residual its sequence slice; ``tok_emb`` row-sharded over
    the mesh (``models.embedding.ShardedLookup``) where its rows divide
    it; the cross-entropy vocabulary-parallel. Prefill and decode ignore
    the mesh, as the reference's serving does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..dist.group_ops import all_gather, all_reduce
from ..dist.sharding import NO_SHARDING, ShardingRules
from ..dist.tensor_parallel import TensorParallel, tensor_parallel
from ..kernels.flash_attention import flash_attention
from ..train.state import TrackedSpec
from .embedding import ShardedLookup, take
from .layers import (MLAConfig, MoEConfig, act_fn, apply_rope, chunked_attention,
                     decode_attention, mla_attention, moe_ffn, rmsnorm)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "silu"
    gated: bool = True
    attn_bias: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rope_theta: float = 1e4
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    aux_loss_coef: float = 0.01
    pure_fsdp_train: bool = False  # the cell's train rules shard only d_model

    @property
    def param_count(self) -> int:
        c = self.vocab * self.d_model * 2  # embed + unembed
        per_layer = 0
        if self.mla:
            m = self.mla
            per_layer += self.d_model * m.q_lora_rank
            per_layer += m.q_lora_rank * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
            per_layer += self.d_model * (m.kv_lora_rank + m.qk_rope_dim)
            per_layer += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
            per_layer += self.n_heads * m.v_head_dim * self.d_model
        else:
            per_layer += self.d_model * self.n_heads * self.head_dim * 2
            per_layer += self.d_model * self.n_kv_heads * self.head_dim * 2
        if self.moe:
            e = self.moe
            n_mats = 3 if e.gated else 2
            per_layer += self.d_model * e.n_experts + e.n_experts * self.d_model * e.d_ff * n_mats
        else:
            n_mats = 3 if self.gated else 2
            per_layer += self.d_model * self.d_ff * n_mats
        return c + self.n_layers * per_layer

    @property
    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.moe:
            return self.param_count
        e = self.moe
        n_mats = 3 if e.gated else 2
        full_moe = self.n_layers * e.n_experts * self.d_model * e.d_ff * n_mats
        active_moe = self.n_layers * e.top_k * self.d_model * e.d_ff * n_mats
        return self.param_count - full_moe + active_moe


# ---------------------------------------------------------------- params


def _stacked(gen: torch.Generator, L: int, shape, scale: Optional[float] = None):
    """Normal weights (L, *shape), each layer's scaled as ``dense_init``
    scales ``shape`` (default ``1/sqrt(shape[0])``), drawn in place."""
    scale = scale if scale is not None else 1.0 / np.sqrt(max(shape[0], 1))
    return torch.randn((L,) + tuple(shape), generator=gen,
                       device=gen.device).mul_(scale)


def init_params(gen: torch.Generator, cfg: TransformerConfig,
                keep: Optional[Callable] = None) -> Dict[str, Any]:
    """Random params on ``gen``'s device, in the reference's tree. Each
    stacked leaf is drawn whole, in place, so a 15.6 B-parameter model is
    made on the card without a second copy of its largest leaf.

    ``keep(path, leaf)`` takes each leaf as it is made, in the order the
    generator draws them, and the tree holds what it returns: a rank of a
    mesh keeps its block (``dist.placement.Placement.init_state``), so no
    rank holds more than one whole leaf at a time, and the blocks hold the
    numbers of one process's whole init."""
    L, d = cfg.n_layers, cfg.d_model
    H, Hkv, Dh, f = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    dev = gen.device
    keep = keep or (lambda path, x: x)
    ones = lambda *shape: torch.ones(shape, device=dev)
    zeros = lambda *shape: torch.zeros(shape, device=dev)

    def made(prefix, **leaves):
        """Each of ``leaves`` (name -> maker, in draw order) made and kept."""
        return {k: keep(prefix + (k,), make()) for k, make in leaves.items()}

    blk = ("dense", "blocks")
    blocks: Dict[str, Any] = made(blk, ln1=lambda: ones(L, d), ln2=lambda: ones(L, d))
    if cfg.mla:
        m = cfg.mla
        blocks["mla"] = made(
            blk + ("mla",),
            w_dq=lambda: _stacked(gen, L, (d, m.q_lora_rank)),
            q_norm=lambda: ones(L, m.q_lora_rank),
            w_uq=lambda: _stacked(gen, L, (m.q_lora_rank, H, m.qk_nope_dim + m.qk_rope_dim)),
            w_dkv=lambda: _stacked(gen, L, (d, m.kv_lora_rank)),
            kv_norm=lambda: ones(L, m.kv_lora_rank),
            w_kpe=lambda: _stacked(gen, L, (d, m.qk_rope_dim)),
            w_uk=lambda: _stacked(gen, L, (m.kv_lora_rank, H, m.qk_nope_dim)),
            w_uv=lambda: _stacked(gen, L, (m.kv_lora_rank, H, m.v_head_dim)),
            w_o=lambda: _stacked(gen, L, (H, m.v_head_dim, d)))
    else:
        attn = dict(wq=lambda: _stacked(gen, L, (d, H, Dh)),
                    wk=lambda: _stacked(gen, L, (d, Hkv, Dh)),
                    wv=lambda: _stacked(gen, L, (d, Hkv, Dh)),
                    wo=lambda: _stacked(gen, L, (H, Dh, d), scale=1.0 / np.sqrt(H * Dh)))
        if cfg.attn_bias:
            attn.update(bq=lambda: zeros(L, H, Dh), bk=lambda: zeros(L, Hkv, Dh),
                        bv=lambda: zeros(L, Hkv, Dh))
        blocks["attn"] = made(blk + ("attn",), **attn)
    if cfg.moe:
        E, fe = cfg.moe.n_experts, cfg.moe.d_ff
        moe = dict(router=lambda: _stacked(gen, L, (d, E)),
                   w_up=lambda: _stacked(gen, L, (E, d, fe)),
                   w_down=lambda: _stacked(gen, L, (E, fe, d), scale=1.0 / np.sqrt(fe)))
        if cfg.moe.gated:
            moe["w_gate"] = lambda: _stacked(gen, L, (E, d, fe))
        blocks["moe"] = made(blk + ("moe",), **moe)
    else:
        ffn = dict(w1=lambda: _stacked(gen, L, (d, f)),
                   w2=lambda: _stacked(gen, L, (f, d), scale=1.0 / np.sqrt(f)))
        if cfg.gated:
            ffn["wg"] = lambda: _stacked(gen, L, (d, f))
        blocks["ffn"] = made(blk + ("ffn",), **ffn)
    dense = dict(blocks=blocks, **made(
        ("dense",), final_norm=lambda: ones(d),
        w_out=lambda: _stacked(gen, 1, (d, cfg.vocab))[0]))
    tables = made(("tables",),
                  tok_emb=lambda: _stacked(gen, 1, (cfg.vocab, d), scale=0.02)[0])
    return dict(tables=tables, dense=dense)


def tracked_specs(cfg: TransformerConfig) -> Dict[str, TrackedSpec]:
    """The token embedding's rows; with MoE the expert blocks too, one unit
    a (layer, expert), viewed as rows of the stacked (L, E, ...) leaf."""
    specs = {"tok_emb": TrackedSpec(path=("tables", "tok_emb"), units=cfg.vocab,
                                    rows=cfg.vocab, dim=cfg.d_model)}
    if cfg.moe:
        L, E, d, F_ = cfg.n_layers, cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff
        specs["moe_w_up"] = TrackedSpec(path=("dense", "blocks", "moe", "w_up"),
                                        units=L * E, rows=L * E * d, dim=F_,
                                        rowwise_aux=False)
        specs["moe_w_down"] = TrackedSpec(path=("dense", "blocks", "moe", "w_down"),
                                          units=L * E, rows=L * E * F_, dim=d,
                                          rowwise_aux=False)
        if cfg.moe.gated:
            specs["moe_w_gate"] = TrackedSpec(path=("dense", "blocks", "moe", "w_gate"),
                                              units=L * E, rows=L * E * d, dim=F_,
                                              rowwise_aux=False)
    return specs


# --------------------------------------------------------------- forward


def project_qkv(x, p, cfg: TransformerConfig, positions):
    """A layer's q (B, S, H, D), k and v (B, S, Hkv, D) from its normed
    input, in the compute dtype, q and k rotated."""
    cd = cfg.compute_dtype
    xc = x.to(cd)
    q = torch.einsum("bsd,dhk->bshk", xc, p["wq"].to(cd))
    k = torch.einsum("bsd,dhk->bshk", xc, p["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", xc, p["wv"].to(cd))
    if cfg.attn_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _attention(x, p, cfg: TransformerConfig, positions, attention: Callable,
               cache=None, cache_len=None):
    cd = cfg.compute_dtype
    S = x.shape[1]
    q, k, v = project_qkv(x, p, cfg, positions)
    if cache is not None:
        # in place: the values of the reference's dynamic_update_slice
        cache["k"][:, cache_len:cache_len + S] = k.to(cache["k"].dtype)
        cache["v"][:, cache_len:cache_len + S] = v.to(cache["v"].dtype)
        new_cache = cache
        out = decode_attention(q, cache["k"].to(cd), cache["v"].to(cd), cache_len + S)
    else:
        new_cache = dict(k=k, v=v)
        out = attention(q, k, v, causal=True)
    y = torch.einsum("bshk,hkd->bsd", out.to(cd), p["wo"].to(cd))
    return y.to(x.dtype), new_cache


def _attention_tp(h, p, cfg: TransformerConfig, positions, tp: TensorParallel):
    """A layer's attention on a rank of a mesh (``dist.tensor_parallel``):
    ``h`` the residual's layout. Where the heads shard, the rank's q heads
    (column-parallel ``wq``, ``bq``), its kv heads where they shard too,
    else the kv heads its q heads attend to, made from the replicated
    ``wk``, ``wv`` (each of its q heads against its own kv head, as
    ``chunked_attention`` groups them); ``wo`` row-parallel, the partial
    sums left over ``model``. Where they do not, every rank attends with
    every head and keeps its own query positions."""
    cd = cfg.compute_dtype
    if not tp.heads:
        q, k, v = project_qkv(tp.whole(h), p, cfg, positions)
        out = tp.own(chunked_attention(q, k, v, causal=True))
        return torch.einsum("bshk,hkd->bsd", out.to(cd), p["wo"].to(cd)).to(h.dtype)
    index = None
    if not tp.kv:
        lo, hi, index = tp.kv_heads(cfg.n_heads, cfg.n_kv_heads)
        p = dict(p, wk=p["wk"][:, lo:hi], wv=p["wv"][:, lo:hi])
        if cfg.attn_bias:
            p.update(bk=p["bk"][lo:hi], bv=p["bv"][lo:hi])
    q, k, v = project_qkv(tp.enter(h), p, cfg, positions)
    if index is not None:
        idx = torch.tensor(index, device=k.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    out = chunked_attention(q, k, v, causal=True)
    y = torch.einsum("bshk,hkd->bsd", out.to(cd), p["wo"].to(cd))
    return tp.leave(y).to(h.dtype)


def _ffn(x, p, cfg: TransformerConfig):
    cd = cfg.compute_dtype
    act = act_fn(cfg.act)
    xc = x.to(cd)
    h = xc @ p["w1"].to(cd)
    if cfg.gated:
        h = act(xc @ p["wg"].to(cd)).to(cd) * h
    else:
        h = act(h).to(cd)
    return (h @ p["w2"].to(cd)).to(x.dtype)


def _ffn_tp(x, p, cfg: TransformerConfig, tp: TensorParallel):
    """The FFN on a rank of a mesh: column-parallel ``w1``/``wg`` and
    row-parallel ``w2`` where ff shards, else whole on the rank's residual
    (position-wise, so on its sequence slice alone)."""
    if not tp.ff:
        return _ffn(x, p, cfg)
    return tp.leave(_ffn(tp.enter(x), p, cfg))


def _layer(x, lp, cfg: TransformerConfig, positions, attention, cache=None,
           cache_len=None, rules: ShardingRules = NO_SHARDING,
           tp: Optional[TensorParallel] = None):
    """One transformer block → (x, new_cache, expert-touched (E,) or None,
    aux loss). With ``tp`` (a rank of a mesh, training) ``x`` is the
    residual's layout there and the block is tensor-parallel."""
    h = rmsnorm(x, lp["ln1"])
    if cfg.mla:
        a, new_cache = mla_attention(h, lp["mla"], cfg.mla, cfg.n_heads, positions,
                                     compute_dtype=cfg.compute_dtype, cache=cache,
                                     cache_len=cache_len, attention=attention, tp=tp)
    elif tp is not None:
        a, new_cache = _attention_tp(h, lp["attn"], cfg, positions, tp), None
    else:
        a, new_cache = _attention(h, lp["attn"], cfg, positions, attention, cache,
                                  cache_len)
    x = x + a
    h = rmsnorm(x, lp["ln2"])
    if cfg.moe:
        f, touched, aux = moe_ffn(h, lp["moe"], cfg.moe, act=act_fn(cfg.act),
                                  compute_dtype=cfg.compute_dtype, rules=rules, tp=tp)
    elif tp is not None:
        f, touched, aux = _ffn_tp(h, lp["ffn"], cfg, tp), None, None
    else:
        f, touched, aux = _ffn(h, lp["ffn"], cfg), None, None
    return x + f, new_cache, touched, aux


def layer_params(blocks, l: int):
    """Layer ``l``'s leaves of the stacked ``blocks`` tree (views)."""
    return {k: (layer_params(v, l) if isinstance(v, dict) else v[l])
            for k, v in blocks.items()}


def forward(params, tokens, cfg: TransformerConfig,
            rules: ShardingRules = NO_SHARDING, caches=None, cache_len=None,
            collect_cache: bool = False, attention: Callable = chunked_attention):
    """Full forward. tokens (B, S) → (hidden (B, S, d), caches,
    expert-touched (L, E) or None, aux loss summed over the layers (f32 0
    without MoE)).

    ``rules`` reach the MoE layers (``moe_ffn``): under a mesh that carries
    a process group, ``tokens`` are this rank's shard of the batch, and the
    expert-parallel dispatch combines over the mesh's ranks (the train
    step's tensor-parallel forward is ``train_loss``'s).

    ``caches`` (``init_cache``'s dict) turns it into decode: each layer
    writes its new keys and values (MLA: latents) at ``cache_len`` in place
    and attends over the cache; the same dict is returned.
    ``collect_cache`` returns each layer's new cache entries stacked
    (L, B, S, ...), as prefill does."""
    B, S = tokens.shape
    x = take(params["tables"]["tok_emb"], tokens).to(cfg.compute_dtype)
    base = 0 if cache_len is None else int(cache_len)
    positions = base + torch.arange(S, device=tokens.device)[None, :]
    return _blocks(params, x, positions, cfg, rules, caches, base, collect_cache, attention)


def _blocks(params, x, positions, cfg: TransformerConfig, rules: ShardingRules,
            caches=None, base: int = 0, collect_cache: bool = False,
            attention: Callable = chunked_attention, tp: Optional[TensorParallel] = None):
    """The layers and the final norm on the embedded ``x``: ``forward``'s
    tuple."""
    blocks = params["dense"]["blocks"]
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    collected, touched, aux = {}, [], []
    for l in range(cfg.n_layers):
        lp = layer_params(blocks, l)
        cache_l = None if caches is None else {k: c[l] for k, c in caches.items()}
        if remat:
            x, new_cache, t_l, a_l = checkpoint(_layer, x, lp, cfg, positions, attention,
                                                rules=rules, tp=tp, use_reentrant=False)
        else:
            x, new_cache, t_l, a_l = _layer(x, lp, cfg, positions, attention, cache_l, base,
                                            rules=rules, tp=tp)
        if collect_cache:
            for k, c in new_cache.items():
                collected.setdefault(k, []).append(c)
        if t_l is not None:
            touched.append(t_l)
            aux.append(a_l)
    x = rmsnorm(x, params["dense"]["final_norm"])
    aux_loss = (torch.sum(torch.stack(aux)) if aux
                else torch.zeros((), dtype=torch.float32, device=x.device))
    touched = torch.stack(touched) if touched else None
    if caches is not None:
        return x, caches, touched, aux_loss
    if collect_cache:
        return x, {k: torch.stack(v) for k, v in collected.items()}, touched, aux_loss
    return x, None, touched, aux_loss


def logits_fn(params, hidden, cfg: TransformerConfig) -> torch.Tensor:
    cd = cfg.compute_dtype
    return (hidden.to(cd) @ params["dense"]["w_out"].to(cd)).to(torch.float32)


def _ce_chunk(params, h, lab, cfg):
    logits = logits_fn(params, h, cfg)                          # (B, sc, V) f32
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 2, lab[..., None].to(torch.int64))[..., 0]
    return torch.sum(lse - gold)


def _ce_chunked(params, hidden, labels, cfg: TransformerConfig, s_chunk: int = 512):
    """Sequence-chunked cross-entropy: each chunk's logits are computed,
    reduced and (in the backward) recomputed, so the (B, S, V) logits are
    never formed. The gold logit is a gather: the reference's masked iota
    sum adds one logit to zeros, the same number."""
    B, S, _ = hidden.shape
    s_chunk = min(s_chunk, S)
    while S % s_chunk:
        s_chunk -= 1
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(S // s_chunk):
        sl = slice(i * s_chunk, (i + 1) * s_chunk)
        if torch.is_grad_enabled():
            part = checkpoint(_ce_chunk, params, hidden[:, sl], labels[:, sl], cfg,
                              use_reentrant=False)
        else:
            part = _ce_chunk(params, hidden[:, sl], labels[:, sl], cfg)
        total = total + part
    return total / (B * S)


def _ce_chunk_vocab(w_out, h, lab, cfg: TransformerConfig, tp: TensorParallel):
    """One chunk's cross-entropy sum from the rank's vocabulary columns
    (``w_out`` (d, V/model)): the logits (B_l, sc, V/model) f32; the
    logsumexp of the ranks' local logsumexps, all-gathered over ``model``
    (backward: each rank's own slice, as every rank computes the same
    loss); the gold logit from the rank that owns the label, summed over
    ``model`` (backward passed through). The whole logits are never
    formed on any rank."""
    cd = cfg.compute_dtype
    logits = (h.to(cd) @ w_out.to(cd)).to(torch.float32)
    lse = torch.logsumexp(all_gather(torch.logsumexp(logits, dim=-1)[None], tp.model,
                                     dim=0, backward="split"), dim=0)
    n = logits.shape[-1]
    local = lab.to(torch.int64) - tp.j * n
    own = (local >= 0) & (local < n)
    gold = torch.gather(logits, 2, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = all_reduce(torch.where(own, gold, gold.new_zeros(())), tp.model,
                      backward="identity")
    return torch.sum(lse - gold)


def _ce_tp(params, hidden, labels, cfg: TransformerConfig, tp: TensorParallel,
           s_chunk: int = 512):
    """The global mean cross-entropy on a rank of a mesh, every rank
    holding it. Where the vocabulary shards: the hidden states of the
    rank's data shard, whole (``tp.enter``), against its vocabulary columns
    (``_ce_chunk_vocab``), the sums added over ``data``. Otherwise the
    rank's own positions against the whole vocabulary (``_ce_chunk``), the
    sums added over every rank that holds other positions. Each chunk is
    checkpointed; its collectives run again in the backward."""
    b, S = labels.shape
    if tp.vocab:
        h, lab = tp.enter(hidden), labels
        part = lambda hc, lc: _ce_chunk_vocab(params["dense"]["w_out"], hc, lc, cfg, tp)
    else:
        h, lab = hidden, tp.own(labels)
        part = lambda hc, lc: _ce_chunk(params, hc, lc, cfg)
    n = h.shape[1]
    s_chunk = min(s_chunk, n)
    while n % s_chunk:
        s_chunk -= 1
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n // s_chunk):
        sl = slice(i * s_chunk, (i + 1) * s_chunk)
        total = total + checkpoint(part, h[:, sl], lab[:, sl], use_reentrant=False)
    total = tp.sum_over(total, spread=tp.sp and not tp.vocab)
    return total / (b * tp.n_data * S)


def _train_loss_tp(params, tokens, labels, cfg: TransformerConfig, rules: ShardingRules,
                   tp: TensorParallel):
    """``train_loss`` on a rank of a mesh: ``tokens`` and ``labels`` its data
    shard. ``tok_emb`` row-sharded over the mesh where its rows divide it:
    under sequence parallelism each rank's own positions are looked up
    (``ShardedLookup.take_sliced``, the exchange in the compute dtype),
    else the data shard's (``ShardedLookup.take``); a replicated table is
    a plain take. The touched mask is the rank's rows of ``tok_emb``,
    marked by the global batch's tokens."""
    V, cd = cfg.vocab, cfg.compute_dtype
    table = params["tables"]["tok_emb"]
    lk = ShardedLookup(rules)
    if lk.sharded(V) and tp.sp:
        ids = lk.ids_over_owners(tp.own(tokens))
        x = lk.take_sliced(table, ids, V, cd)
    elif lk.sharded(V):
        ids = lk.ids(tokens)
        x = lk.take(table, ids, V).to(cd)
    else:
        ids = lk.ids(tokens)
        x = take(table, tp.own(tokens)).to(cd)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    hidden, _, touched_moe, aux_loss = _blocks(params, x, positions, cfg, rules, tp=tp)
    ce = _ce_tp(params, hidden, labels, cfg, tp)
    with torch.no_grad():
        touched = lk.touched(V, ids)
    return ce, aux_loss, touched_moe, touched


def train_loss(params, batch, cfg: TransformerConfig,
               rules: ShardingRules = NO_SHARDING, sharded: bool = False):
    """Causal-LM cross-entropy plus ``aux_loss_coef`` times the MoE layers'
    load-balancing loss. Returns (loss, aux) with the touched masks:
    ``tok_emb``'s rows and, with MoE, the (layer, expert) units of the
    three expert blocks.

    ``sharded``, on a rank of a mesh that carries a process group
    (``rules.mesh``): the tensor-parallel step of that rank
    (``dist.tensor_parallel``, the mesh train cells'): ``batch`` its data
    shard, ``params`` its blocks of the leaves (``dist.placement``), the
    loss the global one, every rank holding it; its MoE layers' aux loss
    is the mean of the data shards' (``models.layers._moe_ep``). Without
    it, on such a rank, only the MoE layers are expert-parallel: the rank
    holds every other leaf whole and its loss is its batch shard's."""
    tokens, labels = batch["tokens"], batch["labels"]
    tp = tensor_parallel(rules, cfg, tokens.shape[1]) if sharded else None
    if tp is not None:
        ce, aux_loss, touched_moe, touched = _train_loss_tp(params, tokens, labels, cfg,
                                                             rules, tp)
    else:
        hidden, _, touched_moe, aux_loss = forward(params, tokens, cfg, rules)
        ce = _ce_chunked(params, hidden, labels, cfg)
        with torch.no_grad():
            touched = torch.zeros((cfg.vocab,), dtype=torch.bool, device=tokens.device)
            touched[tokens.reshape(-1).to(torch.int64)] = True
    loss = ce + cfg.aux_loss_coef * aux_loss
    touched = {"tok_emb": touched}
    if cfg.moe and touched_moe is not None:
        expert_mask = touched_moe.reshape(-1)  # (L*E,)
        touched["moe_w_up"] = expert_mask
        touched["moe_w_down"] = expert_mask
        if cfg.moe.gated:
            touched["moe_w_gate"] = expert_mask
    return loss, dict(ce=ce.detach(), aux_loss=aux_loss.detach(), touched=touched)


# ---------------------------------------------------------------- serving


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """Zero caches made on ``device``: KV (L, batch, max_len, Hkv, D), or
    with MLA the latents ``ckv`` (L, batch, max_len, kv_lora_rank) and
    ``kpe`` (L, batch, max_len, qk_rope_dim)."""
    L = cfg.n_layers
    if cfg.mla:
        m = cfg.mla
        return dict(ckv=torch.zeros((L, batch, max_len, m.kv_lora_rank), dtype=dtype,
                                    device=device),
                    kpe=torch.zeros((L, batch, max_len, m.qk_rope_dim), dtype=dtype,
                                    device=device))
    shape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device))


def decode_step(params, tokens, caches, cache_len, cfg: TransformerConfig,
                rules: ShardingRules = NO_SHARDING):
    """One decode step: tokens (B, T_new) and caches (written in place at
    ``cache_len``) → (logits (B, T_new, V), the caches). Without gradients."""
    with torch.no_grad():
        hidden, caches, _, _ = forward(params, tokens, cfg, rules, caches=caches,
                                       cache_len=int(cache_len))
        return logits_fn(params, hidden, cfg), caches


def prefill_step(params, tokens, cfg: TransformerConfig,
                 rules: ShardingRules = NO_SHARDING,
                 attention: Callable = flash_attention):
    """Prefill: the full forward → (last-position logits (B, 1, V), the KV
    cache stacked (L, B, S, Hkv, D), or with MLA the latents (L, B, S, r)).
    Attends through ``attention``: the
    ``flash_attention`` kernel on a card by default, ``chunked_attention``
    as its plain version. Without gradients."""
    with torch.no_grad():
        hidden, caches, _, _ = forward(params, tokens, cfg, rules, collect_cache=True,
                                       attention=attention)
        return logits_fn(params, hidden[:, -1:, :], cfg), caches
