"""Qwen2-0.5B [arXiv:2407.10671; hf]: 24L d896 14H (GQA kv=2) d_ff 4864,
vocab 151936, SwiGLU, QKV bias."""

from typing import Optional

from ..models.transformer import TransformerConfig
from ._families import lm_cell

FAMILY = "lm"


def make_config(reduced: bool = False) -> TransformerConfig:
    if reduced:
        return TransformerConfig(
            name="qwen2-0.5b-reduced", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, act="silu",
            gated=True, attn_bias=True)
    return TransformerConfig(
        name="qwen2-0.5b", n_layers=24, d_model=896, n_heads=14,
        n_kv_heads=2, head_dim=64, d_ff=4864, vocab=151936, act="silu",
        gated=True, attn_bias=True)


def make_cell(shape: str, reduced: bool = False, device="cuda",
              vocab_cap: Optional[int] = None, global_batch: Optional[int] = None):
    if vocab_cap is not None:
        raise ValueError("qwen2-0.5b takes no vocab cap: its tok_emb "
                         "(151,936 x 896, 544.5 MB f32) fits the card whole")
    return lm_cell("qwen2-0.5b", make_config(reduced), shape, reduced, device,
                   global_batch)
