"""Architecture registry: ``get_cell(arch, shape)`` → CellBundle.

dlrm-rm2 and bert4rec are ported so far; the reference's other eight
architectures come with later slices.
"""

from __future__ import annotations

import importlib
from typing import List, Optional

from ._families import CellBundle

_ARCH_MODULES = {
    "dlrm-rm2": "dlrm_rm2",
    "bert4rec": "bert4rec",
}

ARCHS: List[str] = list(_ARCH_MODULES)


def _module(arch: str):
    try:
        mod_name = _ARCH_MODULES[arch]
    except KeyError:
        raise ValueError(f"unknown or not yet ported arch {arch!r}; have {ARCHS}")
    return importlib.import_module(f".{mod_name}", __package__)


def get_cell(arch: str, shape: str, reduced: bool = False, device="cuda",
             vocab_cap: Optional[int] = None) -> CellBundle:
    """The cell's bundle on ``device`` (the card unless the caller asks for
    the CPU); ``vocab_cap`` caps every table's rows (dlrm-rm2 only)."""
    return _module(arch).make_cell(shape, reduced=reduced, device=device,
                                   vocab_cap=vocab_cap)
