"""BERT4Rec [arXiv:1904.06690]: dim 64, 2 blocks, 2 heads, seq 200,
1M-item catalog, tied output embeddings."""

from typing import Optional

from ..models.bert4rec import Bert4RecConfig
from ._families import recsys_cell

FAMILY = "recsys"

# serve_bulk (262,144 rows) runs in slices of this many rows: the unsliced
# forward's activations (a (B, 200, 256) bf16 FFN hidden alone is 26.8 GB)
# would not fit the card beside its intermediates
SERVE_SLICE_ROWS = 65536


def make_config(reduced: bool = False) -> Bert4RecConfig:
    if reduced:
        return Bert4RecConfig(name="bert4rec-reduced", n_items=2048,
                              embed_dim=16, n_blocks=2, n_heads=2, seq_len=16,
                              d_ff=64, serve_slice_rows=64)
    return Bert4RecConfig(name="bert4rec", n_items=1_000_448, embed_dim=64,
                          n_blocks=2, n_heads=2, seq_len=200, d_ff=256,
                          serve_slice_rows=SERVE_SLICE_ROWS)  # 1M padded to 512x


def make_cell(shape: str, reduced: bool = False, device="cuda",
              vocab_cap: Optional[int] = None, mesh=None,
              global_batch: Optional[int] = None):
    if vocab_cap is not None:
        raise ValueError("bert4rec takes no vocab cap: its 1,000,448-item "
                         "table (256.1 MB f32) fits the card whole")
    return recsys_cell("bert4rec", make_config(reduced), shape, reduced, device,
                       mesh=mesh, global_batch=global_batch)
