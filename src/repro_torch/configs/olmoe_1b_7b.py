"""OLMoE-1B-7B [arXiv:2409.02060; hf]: 16L d2048 16H (kv=16) MoE 64e top-8,
expert d_ff=1024, vocab 50304, SwiGLU."""

from typing import Optional

from ..models.layers import MoEConfig
from ..models.transformer import TransformerConfig
from ._families import lm_cell

FAMILY = "lm"


def make_config(reduced: bool = False) -> TransformerConfig:
    if reduced:
        return TransformerConfig(
            name="olmoe-1b-7b-reduced", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=4, head_dim=16, d_ff=128, vocab=512, act="silu",
            gated=True, moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, gated=True))
    return TransformerConfig(
        name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16,
        n_kv_heads=16, head_dim=128, d_ff=1024, vocab=50304, act="silu",
        gated=True, moe=MoEConfig(n_experts=64, top_k=8, d_ff=1024, gated=True))


def make_cell(shape: str, reduced: bool = False, device="cuda",
              vocab_cap: Optional[int] = None, global_batch: Optional[int] = None,
              mesh=None):
    if vocab_cap is not None:
        raise ValueError("olmoe-1b-7b takes no vocab cap: its tok_emb "
                         "(50,304 x 2,048, 412 MB f32) fits the card whole")
    return lm_cell("olmoe-1b-7b", make_config(reduced), shape, reduced, device,
                   global_batch, mesh=mesh)
