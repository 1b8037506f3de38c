"""MIND [arXiv:1904.08030]: dim 64, 4 interest capsules, 3 routing iters,
1M-item catalog, history length 50."""

from typing import Optional

from ..models.mind import MINDConfig
from ._families import recsys_cell

FAMILY = "recsys"


def make_config(reduced: bool = False) -> MINDConfig:
    if reduced:
        return MINDConfig(name="mind-reduced", n_items=2048, embed_dim=16,
                          n_interests=4, capsule_iters=3, hist_len=10)
    return MINDConfig(name="mind", n_items=1_000_448, embed_dim=64,
                      n_interests=4, capsule_iters=3, hist_len=50)  # 1M padded to 512x


def make_cell(shape: str, reduced: bool = False, device="cuda",
              vocab_cap: Optional[int] = None, mesh=None,
              global_batch: Optional[int] = None):
    if vocab_cap is not None:
        raise ValueError("mind takes no vocab cap: its 1,000,448-item table "
                         "(256.1 MB f32) fits the card whole")
    return recsys_cell("mind", make_config(reduced), shape, reduced, device,
                       mesh=mesh, global_batch=global_batch)
