"""Architecture registry: ``get_cell(arch, shape)`` → CellBundle.

10 architectures × their family's shape set = 40 cells: the recsys family
(xdeepfm, dlrm-rm2, mind, bert4rec), the gnn family (dimenet) and the LM
family (nemotron-4-15b, qwen2-0.5b, olmoe-1b-7b, dbrx-132b, minicpm3-4b).
"""

from __future__ import annotations

import importlib
from typing import List, Optional

from ._families import CellBundle
from .shapes import FAMILY_SHAPES, FAMILY_SHAPES_REDUCED  # noqa: F401

_ARCH_MODULES = {
    "olmoe-1b-7b": "olmoe_1b_7b",
    "dbrx-132b": "dbrx_132b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen2-0.5b": "qwen2_0_5b",
    "minicpm3-4b": "minicpm3_4b",
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
        raise ValueError(f"unknown arch {arch!r}; have {ARCHS}")
    return importlib.import_module(f".{mod_name}", __package__)


def arch_family(arch: str) -> str:
    return _module(arch).FAMILY


def arch_shapes(arch: str) -> List[str]:
    return list(FAMILY_SHAPES[arch_family(arch)])


def all_cells() -> List[tuple]:
    """The 40 (arch, shape) pairs, in the reference's order."""
    return [(a, s) for a in ARCHS for s in arch_shapes(a)]


def get_cell(arch: str, shape: str, reduced: bool = False, device="cuda",
             vocab_cap: Optional[int] = None,
             global_batch: Optional[int] = None, mesh=None) -> CellBundle:
    """The cell's bundle on ``device`` (the card unless the caller asks for
    the CPU; ``"meta"`` for shapes alone); ``vocab_cap`` caps every table's
    rows (dlrm-rm2 only: the other archs' tables fit the card whole, and
    their cells refuse a cap); ``global_batch`` replaces an LM shape's batch
    or a recsys train cell's (not dimenet's); ``mesh`` (``launch.mesh.Mesh``) gives the bundle
    its family's sharding rules and partition specs (none without)."""
    kw = {} if global_batch is None else dict(global_batch=global_batch)
    return _module(arch).make_cell(shape, reduced=reduced, device=device,
                                   vocab_cap=vocab_cap, mesh=mesh, **kw)
