"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B]: 62L d2560 40H, MLA (q_lora 768,
kv_lora 256, qk_nope 64, qk_rope 32, v 64), d_ff 6400, vocab 73448, SwiGLU."""

from typing import Optional

from ..models.layers import MLAConfig
from ..models.transformer import TransformerConfig
from ._families import lm_cell

FAMILY = "lm"


def make_config(reduced: bool = False) -> TransformerConfig:
    if reduced:
        return TransformerConfig(
            name="minicpm3-4b-reduced", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=4, head_dim=24, d_ff=128, vocab=512, act="silu",
            gated=True,
            mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                          qk_rope_dim=8, v_head_dim=16))
    return TransformerConfig(
        name="minicpm3-4b", n_layers=62, d_model=2560, n_heads=40,
        n_kv_heads=40, head_dim=96, d_ff=6400, vocab=73472, act="silu",  # 73448 padded %16
        gated=True,
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64,
                      qk_rope_dim=32, v_head_dim=64))


def make_cell(shape: str, reduced: bool = False, device="cuda",
              vocab_cap: Optional[int] = None, global_batch: Optional[int] = None,
              mesh=None):
    if vocab_cap is not None:
        raise ValueError("minicpm3-4b takes no vocab cap: its tok_emb "
                         "(73,472 x 2,560, 752 MB f32) fits the card whole")
    return lm_cell("minicpm3-4b", make_config(reduced), shape, reduced, device,
                   global_batch, mesh=mesh)
