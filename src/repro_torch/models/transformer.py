"""Transformer LM family, in PyTorch: the dense models, nemotron-4-15b
(squared-ReLU, no GLU, no bias) and qwen2-0.5b (GQA, SwiGLU, QKV bias).

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
  * Decode: the reference's plain ``decode_attention`` against the cache.
    The cache is written in place (the reference updates it functionally;
    the values are the same), so a 51.5 GB cache is never copied.

The reference's MoE and MLA branches (olmoe, dbrx, minicpm3) come with the
rest of ROADMAP A6.4; a config that sets either raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import flash_attention
from ..train.state import TrackedSpec
from .embedding import take
from .layers import act_fn, apply_rope, chunked_attention, decode_attention, rmsnorm


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
    moe: Optional[Any] = None   # the reference's MoEConfig: ROADMAP A6.4
    mla: Optional[Any] = None   # the reference's MLAConfig: ROADMAP A6.4
    rope_theta: float = 1e4
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True

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


def _dense_only(cfg: TransformerConfig) -> None:
    if cfg.moe or cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: the MoE and MLA branches are not ported yet "
            f"(ROADMAP A6.4); the port runs the dense LMs")


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
    _dense_only(cfg)
    L, d = cfg.n_layers, cfg.d_model
    H, Hkv, Dh, f = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    dev = gen.device
    attn = dict(wq=_stacked(gen, L, (d, H, Dh)), wk=_stacked(gen, L, (d, Hkv, Dh)),
                wv=_stacked(gen, L, (d, Hkv, Dh)),
                wo=_stacked(gen, L, (H, Dh, d), scale=1.0 / np.sqrt(H * Dh)))
    if cfg.attn_bias:
        attn.update(bq=torch.zeros((L, H, Dh), device=dev),
                    bk=torch.zeros((L, Hkv, Dh), device=dev),
                    bv=torch.zeros((L, Hkv, Dh), device=dev))
    ffn = dict(w1=_stacked(gen, L, (d, f)),
               w2=_stacked(gen, L, (f, d), scale=1.0 / np.sqrt(f)))
    if cfg.gated:
        ffn["wg"] = _stacked(gen, L, (d, f))
    blocks = dict(ln1=torch.ones((L, d), device=dev), ln2=torch.ones((L, d), device=dev),
                  attn=attn, ffn=ffn)
    dense = dict(blocks=blocks, final_norm=torch.ones((d,), device=dev),
                 w_out=_stacked(gen, 1, (d, cfg.vocab))[0])
    tables = dict(tok_emb=_stacked(gen, 1, (cfg.vocab, d), scale=0.02)[0])
    return dict(tables=tables, dense=dense)


def tracked_specs(cfg: TransformerConfig) -> Dict[str, TrackedSpec]:
    """The token embedding's rows."""
    _dense_only(cfg)
    return {"tok_emb": TrackedSpec(path=("tables", "tok_emb"), units=cfg.vocab,
                                   rows=cfg.vocab, dim=cfg.d_model)}


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
           cache_len=None):
    """One transformer block → (x, new_cache)."""
    h = rmsnorm(x, lp["ln1"])
    a, new_cache = _attention(h, lp["attn"], cfg, positions, attention, cache, cache_len)
    x = x + a
    x = x + _ffn(rmsnorm(x, lp["ln2"]), lp["ffn"], cfg)
    return x, new_cache


def layer_params(blocks, l: int):
    """Layer ``l``'s leaves of the stacked ``blocks`` tree (views)."""
    return {k: (layer_params(v, l) if isinstance(v, dict) else v[l])
            for k, v in blocks.items()}


def forward(params, tokens, cfg: TransformerConfig, caches=None, cache_len=None,
            collect_cache: bool = False, attention: Callable = chunked_attention):
    """Full forward. tokens (B, S) → (hidden (B, S, d), caches).

    ``caches`` (``init_cache``'s dict) turns it into decode: each layer
    writes its new keys and values at ``cache_len`` in place and attends
    over the cache; the same dict is returned. ``collect_cache`` returns the
    layers' keys and values stacked (L, B, S, Hkv, D), as prefill does."""
    _dense_only(cfg)
    B, S = tokens.shape
    x = take(params["tables"]["tok_emb"], tokens).to(cfg.compute_dtype)
    base = 0 if cache_len is None else int(cache_len)
    positions = base + torch.arange(S, device=tokens.device)[None, :]
    blocks = params["dense"]["blocks"]
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    keys, values = [], []
    for l in range(cfg.n_layers):
        lp = layer_params(blocks, l)
        cache_l = None if caches is None else {k: c[l] for k, c in caches.items()}
        if remat:
            x, new_cache = checkpoint(_layer, x, lp, cfg, positions, attention,
                                      use_reentrant=False)
        else:
            x, new_cache = _layer(x, lp, cfg, positions, attention, cache_l, base)
        if collect_cache:
            keys.append(new_cache["k"])
            values.append(new_cache["v"])
    x = rmsnorm(x, params["dense"]["final_norm"])
    if caches is not None:
        return x, caches
    if collect_cache:
        return x, dict(k=torch.stack(keys), v=torch.stack(values))
    return x, None


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


def train_loss(params, batch, cfg: TransformerConfig):
    """Causal-LM cross-entropy. Returns (loss, aux) with the tok_emb
    touched mask."""
    tokens, labels = batch["tokens"], batch["labels"]
    hidden, _ = forward(params, tokens, cfg)
    ce = _ce_chunked(params, hidden, labels, cfg)
    with torch.no_grad():
        touched = torch.zeros((cfg.vocab,), dtype=torch.bool, device=tokens.device)
        touched[tokens.reshape(-1).to(torch.int64)] = True
    # the dense layers have no auxiliary loss: the reference adds 0
    return ce, dict(ce=ce.detach(), touched={"tok_emb": touched})


# ---------------------------------------------------------------- serving


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """Zero KV caches (L, batch, max_len, Hkv, D), made on ``device``."""
    _dense_only(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device))


def decode_step(params, tokens, caches, cache_len, cfg: TransformerConfig):
    """One decode step: tokens (B, T_new) and caches (written in place at
    ``cache_len``) → (logits (B, T_new, V), the caches). Without gradients."""
    with torch.no_grad():
        hidden, caches = forward(params, tokens, cfg, caches=caches,
                                 cache_len=int(cache_len))
        return logits_fn(params, hidden, cfg), caches


def prefill_step(params, tokens, cfg: TransformerConfig,
                 attention: Callable = flash_attention):
    """Prefill: the full forward → (last-position logits (B, 1, V), the KV
    cache stacked (L, B, S, Hkv, D)). Attends through ``attention``: the
    ``flash_attention`` kernel on a card by default, ``chunked_attention``
    as its plain version. Without gradients."""
    with torch.no_grad():
        hidden, caches = forward(params, tokens, cfg, collect_cache=True,
                                 attention=attention)
        return logits_fn(params, hidden[:, -1:, :], cfg), caches
