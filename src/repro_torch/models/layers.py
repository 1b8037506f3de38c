"""Dense-layer building blocks, in PyTorch: the parts of
``src/repro/models/layers.py`` that the ported models use — ``dense_init``,
``layernorm``, the tanh-approximated GELU, and ``chunked_attention``, the
online-softmax attention the transformer models train through."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = float(np.finfo(np.float32).min)


def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.float32) -> torch.Tensor:
    """Normal weights times ``scale`` (default ``1/sqrt(fan_in)``), drawn
    from ``gen`` on the generator's device. The numbers differ from the
    reference's ``jax.random`` ones; the distribution is the same."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
    return torch.randn(tuple(shape), generator=gen, dtype=dtype,
                       device=gen.device) * scale


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis in f32 (population variance), returned
    in ``x``'s dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    out = ((x - mu) * torch.rsqrt(var + eps) * gamma.to(torch.float32)
           + beta.to(torch.float32))
    return out.to(dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def chunked_attention(q, k, v, *, causal: bool, q_chunk: int = 512,
                      k_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks inside a loop over Q chunks,
    the reference's ``chunked_attention``: f32 scores scaled by
    ``1/sqrt(D)``, masked scores at the f32 minimum, GQA, the output in q's
    dtype. Differentiable; each Q chunk's body is recomputed in the
    backward (``torch.utils.checkpoint``, as the reference's
    ``jax.checkpoint``), so no (q_chunk, k_chunk) score block is kept.

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) with Hq % Hkv == 0.
    Returns (B, Sq, Hq, D).
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = 1.0 / np.sqrt(D)
    orig_Sq, orig_Sk = Sq, Sk
    q_chunk = min(q_chunk, max(Sq, 8))
    k_chunk = min(k_chunk, max(Sk, 8))
    if Sq % q_chunk:
        q = F.pad(q, (0, 0, 0, 0, 0, q_chunk - Sq % q_chunk))
        Sq = q.shape[1]
    if Sk % k_chunk:
        pad = (0, 0, 0, 0, 0, k_chunk - Sk % k_chunk)
        k, v = F.pad(k, pad), F.pad(v, pad)
        Sk = k.shape[1]
    nq, nk = Sq // q_chunk, Sk // k_chunk
    kf, vf = k.to(torch.float32), v.to(torch.float32)

    def q_body(qc, qi):
        qg = qc.reshape(B, q_chunk, Hkv, G, D).to(torch.float32)
        m = torch.full((B, Hkv, G, q_chunk), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, G, q_chunk), device=q.device)
        acc = torch.zeros((B, Hkv, G, q_chunk, D), device=q.device)
        for ki in range(nk):
            kc = kf[:, ki * k_chunk:(ki + 1) * k_chunk]
            vc = vf[:, ki * k_chunk:(ki + 1) * k_chunk]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc) * scale
            kpos = ki * k_chunk + torch.arange(k_chunk, device=q.device)
            if causal:
                qpos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
                s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
            if orig_Sk != Sk:  # zero-padded keys must not enter the softmax
                s = torch.where(kpos < orig_Sk, s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vc)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)   # (B,Hkv,G,qc,D)
        return out.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, Hq, D).to(q.dtype)

    outs = []
    for qi in range(nq):
        qc = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        if torch.is_grad_enabled():
            outs.append(checkpoint(q_body, qc, qi, use_reentrant=False))
        else:
            outs.append(q_body(qc, qi))
    out = outs[0] if nq == 1 else torch.cat(outs, dim=1)
    return out[:, :orig_Sq]
