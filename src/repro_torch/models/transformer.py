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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..dist.sharding import NO_SHARDING, ShardingRules
from ..kernels.flash_attention import flash_attention
from ..train.state import TrackedSpec
from .embedding import take
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


def init_params(gen: torch.Generator, cfg: TransformerConfig) -> Dict[str, Any]:
    """Random params on ``gen``'s device, in the reference's tree. Each
    stacked leaf is drawn whole, in place, so a 15.6 B-parameter model is
    made on the card without a second copy of its largest leaf."""
    L, d = cfg.n_layers, cfg.d_model
    H, Hkv, Dh, f = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    dev = gen.device
    blocks: Dict[str, Any] = dict(ln1=torch.ones((L, d), device=dev),
                                  ln2=torch.ones((L, d), device=dev))
    if cfg.mla:
        m = cfg.mla
        blocks["mla"] = dict(
            w_dq=_stacked(gen, L, (d, m.q_lora_rank)),
            q_norm=torch.ones((L, m.q_lora_rank), device=dev),
            w_uq=_stacked(gen, L, (m.q_lora_rank, H, m.qk_nope_dim + m.qk_rope_dim)),
            w_dkv=_stacked(gen, L, (d, m.kv_lora_rank)),
            kv_norm=torch.ones((L, m.kv_lora_rank), device=dev),
            w_kpe=_stacked(gen, L, (d, m.qk_rope_dim)),
            w_uk=_stacked(gen, L, (m.kv_lora_rank, H, m.qk_nope_dim)),
            w_uv=_stacked(gen, L, (m.kv_lora_rank, H, m.v_head_dim)),
            w_o=_stacked(gen, L, (H, m.v_head_dim, d)))
    else:
        attn = dict(wq=_stacked(gen, L, (d, H, Dh)), wk=_stacked(gen, L, (d, Hkv, Dh)),
                    wv=_stacked(gen, L, (d, Hkv, Dh)),
                    wo=_stacked(gen, L, (H, Dh, d), scale=1.0 / np.sqrt(H * Dh)))
        if cfg.attn_bias:
            attn.update(bq=torch.zeros((L, H, Dh), device=dev),
                        bk=torch.zeros((L, Hkv, Dh), device=dev),
                        bv=torch.zeros((L, Hkv, Dh), device=dev))
        blocks["attn"] = attn
    if cfg.moe:
        E, fe = cfg.moe.n_experts, cfg.moe.d_ff
        moe = dict(router=_stacked(gen, L, (d, E)), w_up=_stacked(gen, L, (E, d, fe)),
                   w_down=_stacked(gen, L, (E, fe, d), scale=1.0 / np.sqrt(fe)))
        if cfg.moe.gated:
            moe["w_gate"] = _stacked(gen, L, (E, d, fe))
        blocks["moe"] = moe
    else:
        ffn = dict(w1=_stacked(gen, L, (d, f)),
                   w2=_stacked(gen, L, (f, d), scale=1.0 / np.sqrt(f)))
        if cfg.gated:
            ffn["wg"] = _stacked(gen, L, (d, f))
        blocks["ffn"] = ffn
    dense = dict(blocks=blocks, final_norm=torch.ones((d,), device=dev),
                 w_out=_stacked(gen, 1, (d, cfg.vocab))[0])
    tables = dict(tok_emb=_stacked(gen, 1, (cfg.vocab, d), scale=0.02)[0])
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


def _layer(x, lp, cfg: TransformerConfig, positions, attention, cache=None,
           cache_len=None, rules: ShardingRules = NO_SHARDING):
    """One transformer block → (x, new_cache, expert-touched (E,) or None,
    aux loss)."""
    h = rmsnorm(x, lp["ln1"])
    if cfg.mla:
        a, new_cache = mla_attention(h, lp["mla"], cfg.mla, cfg.n_heads, positions,
                                     compute_dtype=cfg.compute_dtype, cache=cache,
                                     cache_len=cache_len, attention=attention)
    else:
        a, new_cache = _attention(h, lp["attn"], cfg, positions, attention, cache,
                                  cache_len)
    x = x + a
    h = rmsnorm(x, lp["ln2"])
    if cfg.moe:
        f, touched, aux = moe_ffn(h, lp["moe"], cfg.moe, act=act_fn(cfg.act),
                                  compute_dtype=cfg.compute_dtype, rules=rules)
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
    expert-parallel dispatch combines over the mesh's ranks.

    ``caches`` (``init_cache``'s dict) turns it into decode: each layer
    writes its new keys and values (MLA: latents) at ``cache_len`` in place
    and attends over the cache; the same dict is returned.
    ``collect_cache`` returns each layer's new cache entries stacked
    (L, B, S, ...), as prefill does."""
    B, S = tokens.shape
    x = take(params["tables"]["tok_emb"], tokens).to(cfg.compute_dtype)
    base = 0 if cache_len is None else int(cache_len)
    positions = base + torch.arange(S, device=tokens.device)[None, :]
    blocks = params["dense"]["blocks"]
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    collected, touched, aux = {}, [], []
    for l in range(cfg.n_layers):
        lp = layer_params(blocks, l)
        cache_l = None if caches is None else {k: c[l] for k, c in caches.items()}
        if remat:
            x, new_cache, t_l, a_l = checkpoint(_layer, x, lp, cfg, positions, attention,
                                                rules=rules, use_reentrant=False)
        else:
            x, new_cache, t_l, a_l = _layer(x, lp, cfg, positions, attention, cache_l, base,
                                            rules=rules)
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


def train_loss(params, batch, cfg: TransformerConfig,
               rules: ShardingRules = NO_SHARDING):
    """Causal-LM cross-entropy plus ``aux_loss_coef`` times the MoE layers'
    load-balancing loss. Returns (loss, aux) with the touched masks:
    ``tok_emb``'s rows and, with MoE, the (layer, expert) units of the
    three expert blocks."""
    tokens, labels = batch["tokens"], batch["labels"]
    hidden, _, touched_moe, aux_loss = forward(params, tokens, cfg, rules)
    ce = _ce_chunked(params, hidden, labels, cfg)
    loss = ce + cfg.aux_loss_coef * aux_loss
    with torch.no_grad():
        touched = torch.zeros((cfg.vocab,), dtype=torch.bool, device=tokens.device)
        touched[tokens.reshape(-1).to(torch.int64)] = True
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
