"""DLRM RM2 [arXiv:1906.00091]: 13 dense + 26 sparse (dim 64), bottom MLP
13-512-256-64, top MLP 512-512-256-1, dot interaction. Vocab sizes follow
the Criteo-Terabyte cardinalities (the paper's public proxy workload)."""

import dataclasses
from typing import Optional

from ..models.dlrm import DLRMConfig
from ..models.embedding import pad_rows
from ._families import recsys_cell

FAMILY = "recsys"

# Criteo-Terabyte per-field cardinalities (day-sampled, standard
# preprocessing); padded to multiples of 512 so rows shard evenly over the
# model×data mesh (padding rows are never looked up).
CRITEO_TB_VOCABS = tuple(pad_rows(v) for v in (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
))


def make_config(reduced: bool = False,
                vocab_cap: Optional[int] = None) -> DLRMConfig:
    """``vocab_cap`` caps every table's rows (full width otherwise): the
    full Criteo-TB vocabulary is 187,775,488 rows, 48.1 GB in f32."""
    if reduced:
        vocabs = tuple(max(v // 100000, 32) for v in CRITEO_TB_VOCABS)
        cfg = DLRMConfig(name="dlrm-rm2-reduced", vocab_sizes=vocabs,
                         embed_dim=16, bot_mlp=(32, 16), top_mlp=(32, 16, 1))
    else:
        cfg = DLRMConfig(name="dlrm-rm2", vocab_sizes=CRITEO_TB_VOCABS)
    if vocab_cap is not None:
        cfg = dataclasses.replace(cfg, vocab_sizes=tuple(
            min(v, vocab_cap) for v in cfg.vocab_sizes))
    return cfg


def make_cell(shape: str, reduced: bool = False, device="cuda",
              vocab_cap: Optional[int] = None):
    return recsys_cell("dlrm-rm2", make_config(reduced, vocab_cap), shape,
                       reduced, device)
