"""xDeepFM [arXiv:1803.05170]: 39 sparse fields (dim 10), CIN 200-200-200,
deep MLP 400-400. Field cardinalities: Criteo-style heavy-tail mix."""

from typing import Optional

from ..models.embedding import pad_rows
from ..models.xdeepfm import XDeepFMConfig
from ._families import recsys_cell

FAMILY = "recsys"

# heavy-tail Criteo-style cardinalities, padded (see dlrm_rm2.py): 22,451,200
# rows a table family
XDEEPFM_VOCABS = tuple(pad_rows(v) for v in (
    9999999, 4999999, 2999999, 1999999, 999999, 599999, 399999, 199999,
    99999, 49999, 29999, 19999, 9999, 9999, 4999, 4999, 2999, 1999,
    999, 999, 499, 499, 299, 199, 99, 99, 63, 63, 31, 31,
    15, 15, 11, 11, 7, 7, 5, 4, 3,
))


def make_config(reduced: bool = False) -> XDeepFMConfig:
    if reduced:
        vocabs = tuple(max(v // 100000, 16) for v in XDEEPFM_VOCABS)
        return XDeepFMConfig(name="xdeepfm-reduced", vocab_sizes=vocabs,
                             embed_dim=4, cin_layers=(8, 8), mlp=(16, 16))
    return XDeepFMConfig(name="xdeepfm", vocab_sizes=XDEEPFM_VOCABS)


def make_cell(shape: str, reduced: bool = False, device="cuda",
              vocab_cap: Optional[int] = None):
    if vocab_cap is not None:
        raise ValueError("xdeepfm takes no vocab cap: its two table families "
                         "(22,451,200 rows each, dims 10 and 1: 0.99 GB f32) "
                         "fit the card whole")
    return recsys_cell("xdeepfm", make_config(reduced), shape, reduced, device)
