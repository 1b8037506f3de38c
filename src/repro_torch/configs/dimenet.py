"""DimeNet [arXiv:2003.03123]: 6 blocks, hidden 128, 8 bilinear, 7 spherical,
6 radial. Non-molecular graphs take a learned 3-D position projection of
their node features."""

from typing import Optional

from ..models.dimenet import DimeNetConfig
from ._families import gnn_cell

FAMILY = "gnn"


def make_config(reduced: bool = False) -> DimeNetConfig:
    if reduced:
        return DimeNetConfig(name="dimenet-reduced", n_blocks=2, d_hidden=16,
                             n_bilinear=2, n_spherical=3, n_radial=2)
    return DimeNetConfig(name="dimenet", n_blocks=6, d_hidden=128,
                         n_bilinear=8, n_spherical=7, n_radial=6)


def make_cell(shape: str, reduced: bool = False, device="cuda",
              vocab_cap: Optional[int] = None):
    if vocab_cap is not None:
        raise ValueError("dimenet takes no vocab cap: its one table is the "
                         "95-row species embedding")
    return gnn_cell("dimenet", make_config(reduced), shape, reduced, device)
