"""The plain PyTorch version of the flash-attention kernel: the same
function in whole-tile form. Scores in f32 scaled by ``1/sqrt(D)``, masked
scores at exactly the f32 minimum (``NEG_INF`` of the Pallas kernel), the
softmax normalised by ``max(l, 1e-30)``, the output in q's dtype. GQA maps
q head ``h`` to kv head ``h // G``.

It materialises the (B, Hkv, G, Sq, Sk) f32 scores, so it runs the batch in
slices of at most ``MAX_SCORES`` score elements (each row's result does not
depend on the others)."""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = float(np.finfo(np.float32).min)
MAX_SCORES = 1 << 28  # 1 GiB of f32 scores per slice


def _attend(q, k, v, causal: bool) -> torch.Tensor:
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32)) * (1.0 / np.sqrt(D))
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.to(torch.float32))
    o = o / torch.clamp(l, min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D) → (B, Sq, Hq, D) in q's dtype,
    on q's device."""
    B, Sq, Hq, _ = q.shape
    Sk = k.shape[1]
    rows = max(1, MAX_SCORES // max(1, Hq * Sq * Sk))
    if B <= rows:
        return _attend(q, k, v, causal)
    return torch.cat([_attend(q[i:i + rows], k[i:i + rows], v[i:i + rows], causal)
                      for i in range(0, B, rows)])
