"""DBRX-132B [hf:databricks/dbrx-base]: 40L d6144 48H (GQA kv=8) MoE 16e
top-4, expert d_ff=10752, vocab 100352, GLU."""

from typing import Optional

from ..models.layers import MoEConfig
from ..models.transformer import TransformerConfig
from ._families import lm_cell

FAMILY = "lm"


def make_config(reduced: bool = False) -> TransformerConfig:
    if reduced:
        return TransformerConfig(
            name="dbrx-132b-reduced", n_layers=2, d_model=64, n_heads=8,
            n_kv_heads=2, head_dim=8, d_ff=192, vocab=512, act="silu",
            gated=True, moe=MoEConfig(n_experts=4, top_k=2, d_ff=48, gated=True))
    return TransformerConfig(
        name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48,
        n_kv_heads=8, head_dim=128, d_ff=10752, vocab=100352, act="silu",
        gated=True, moe=MoEConfig(n_experts=16, top_k=4, d_ff=10752, gated=True))


def make_cell(shape: str, reduced: bool = False, device="cuda",
              vocab_cap: Optional[int] = None, global_batch: Optional[int] = None,
              mesh=None):
    if vocab_cap is not None:
        raise ValueError("dbrx-132b takes no vocab cap: its tok_emb "
                         "(100,352 x 6,144, 2.47 GB f32) fits the card whole")
    return lm_cell("dbrx-132b", make_config(reduced), shape, reduced, device,
                   global_batch, mesh=mesh)
