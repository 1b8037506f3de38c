"""Architecture registry: ``get_cell(arch, shape)`` → CellBundle.

Ported: the recsys family (xdeepfm, dlrm-rm2, mind, bert4rec), the gnn
family (dimenet) and the dense LMs (nemotron-4-15b, qwen2-0.5b). Still to
come: the MoE and MLA LMs (olmoe-1b-7b, dbrx-132b, minicpm3-4b; ROADMAP
A6.4), then the 40-cell registry's ``all_cells``, ``arch_family`` and
``arch_shapes`` with the mesh slice (A6.5).
"""

from __future__ import annotations

import importlib
from typing import List, Optional

from ._families import CellBundle

_ARCH_MODULES = {
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen2-0.5b": "qwen2_0_5b",
    "dimenet": "dimenet",
    "xdeepfm": "xdeepfm",
    "dlrm-rm2": "dlrm_rm2",
    "mind": "mind",
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
             vocab_cap: Optional[int] = None,
             global_batch: Optional[int] = None) -> CellBundle:
    """The cell's bundle on ``device`` (the card unless the caller asks for
    the CPU); ``vocab_cap`` caps every table's rows (dlrm-rm2 only: the
    other archs' tables fit the card whole, and their cells refuse a cap);
    ``global_batch`` replaces an LM shape's batch (the LM cells only)."""
    kw = {} if global_batch is None else dict(global_batch=global_batch)
    return _module(arch).make_cell(shape, reduced=reduced, device=device,
                                   vocab_cap=vocab_cap, **kw)
