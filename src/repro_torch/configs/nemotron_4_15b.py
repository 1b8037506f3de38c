"""Nemotron-4-15B [arXiv:2402.16819]: 32L d6144 48H (GQA kv=8) d_ff 24576,
vocab 256000, squared-ReLU (no GLU), no bias."""

from typing import Optional

from ..models.transformer import TransformerConfig
from ._families import lm_cell

FAMILY = "lm"


def make_config(reduced: bool = False) -> TransformerConfig:
    if reduced:
        return TransformerConfig(
            name="nemotron-4-15b-reduced", n_layers=2, d_model=64, n_heads=8,
            n_kv_heads=2, head_dim=8, d_ff=256, vocab=512, act="relu2",
            gated=False)
    return TransformerConfig(
        name="nemotron-4-15b", n_layers=32, d_model=6144, n_heads=48,
        n_kv_heads=8, head_dim=128, d_ff=24576, vocab=256000, act="relu2",
        gated=False)


def make_cell(shape: str, reduced: bool = False, device="cuda",
              vocab_cap: Optional[int] = None, global_batch: Optional[int] = None,
              mesh=None):
    if vocab_cap is not None:
        raise ValueError("nemotron-4-15b takes no vocab cap")
    return lm_cell("nemotron-4-15b", make_config(reduced), shape, reduced, device,
                   global_batch, mesh=mesh)
