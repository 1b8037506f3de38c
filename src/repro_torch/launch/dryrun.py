"""The port's dry run: every (architecture × input shape) cell on a
production mesh, sized without running it.

For each cell the bundle is built on the ``meta`` device (params, train
state and inputs: shapes and dtypes, no storage, so dbrx-132b's 132 B
parameters cost nothing), its partition specs are read on the abstract
mesh (``launch.mesh.make_production_mesh``), and each device's share is
counted: the local shard of every leaf the step takes (the train state, or
the params of a serving cell, and the inputs), summed — the counterpart of
the reference's ``memory_analysis().argument_size_in_bytes``. Beside it:
the cell's ``model_flops`` and whether its per-device bytes fit the card
(``torch.cuda.get_device_properties(0).total_memory``; ``null`` without a
card). The reference's compiled ``flops`` and per-type collective bytes
are absent: the port has no compiler to read them from, and their count
from the port's explicit collective calls comes with ROADMAP A6.5b.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dlrm-rm2 --shape train_batch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results/]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Optional

import numpy as np
import torch

from ..configs import all_cells, get_cell
from ..configs._families import InputSpec
from ..dist.sharding import PartitionSpec
from ..tree import flatten_with_path, keystr
from .mesh import Mesh, make_production_mesh

NOT_YET = ("collectives and the compiled flops: counted from the port's "
           "explicit collective calls with ROADMAP A6.5b")


def _axes(entry):
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_shape(shape, spec: PartitionSpec, mesh: Mesh):
    """The local shard's shape of a ``shape`` leaf laid out by ``spec`` on
    ``mesh``: each dimension over the product of its axes, rounded up as
    XLA pads an uneven split."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(math.ceil(d / math.prod(mesh.shape[a] for a in _axes(e)))
                 for d, e in zip(shape, spec))


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def _leaf_shape_dtype(leaf):
    """(shape, dtype) of a tensor, a numpy array, or a host int (the
    port's ``step``: the reference's int32 scalar)."""
    if isinstance(leaf, int):
        return (), np.int32
    return tuple(leaf.shape), leaf.dtype


def meta_inputs(specs):
    """The cell's inputs (``make_inputs()``'s tree of ``InputSpec``) as
    tensors on the meta device."""
    if isinstance(specs, InputSpec):
        dt = specs.dtype if isinstance(specs.dtype, torch.dtype) else \
            torch.from_numpy(np.empty(0, specs.dtype)).dtype
        return torch.empty(specs.shape, dtype=dt, device="meta")
    return {k: meta_inputs(v) for k, v in specs.items()}


def device_bytes(tree, specs, mesh: Mesh) -> int:
    """One device's bytes of ``tree``: each leaf's local shard, its spec
    the leaf at the same path of ``specs``."""
    spec_at = {keystr(p): s for p, s in flatten_with_path(specs)}
    total = 0
    for path, leaf in flatten_with_path(tree):
        shape, dtype = _leaf_shape_dtype(leaf)
        total += math.prod(shard_shape(shape, spec_at[keystr(path)], mesh)) * _itemsize(dtype)
    return total


def _state_tree(state):
    """A TrainState as a dict, so the tree helpers walk it."""
    return dict(step=state.step, params=state.params, opt_state=state.opt_state,
                touched=state.touched, rng=state.rng)


def argument_bytes(bundle, mesh: Mesh) -> dict:
    """One device's bytes of what the cell's step takes, split as
    ``state`` (a train cell's TrainState) or ``params`` (a serving cell's),
    and ``inputs``; built on the meta device."""
    if bundle.kind == "train":
        st = bundle.state_shapes()
        name, tree, specs = "state", _state_tree(st), _state_tree(bundle.state_pspecs(st))
    else:
        ps = bundle.params_shapes()
        name, tree, specs = "params", ps, bundle.params_pspecs(ps)
    inputs = meta_inputs(bundle.make_inputs())
    return {name: device_bytes(tree, specs, mesh),
            "inputs": device_bytes(inputs, bundle.input_pspecs, mesh)}


def card_bytes() -> Optional[int]:
    """The card's memory, or None without one (never a guessed size)."""
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.get_device_properties(0).total_memory)


def run_cell(arch: str, shape: str, multi_pod: bool,
             card: Optional[int] = None) -> dict:
    t0 = time.monotonic()
    mesh = make_production_mesh(multi_pod=multi_pod)
    bundle = get_cell(arch, shape, device="meta", mesh=mesh)
    split = argument_bytes(bundle, mesh)
    arg = sum(split.values())
    return dict(
        arch=arch, shape=shape, kind=bundle.kind,
        mesh="2x16x16" if multi_pod else "16x16",
        n_devices=mesh.size,
        memory=dict(argument_size=arg, argument_split=split),
        model_flops=bundle.model_flops,
        card_bytes=card,
        fits_card=None if card is None else arg <= card,
        not_yet=NOT_YET,
        build_s=round(time.monotonic() - t0, 3),
        status="ok",
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="results")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    cells = all_cells() if args.all else [(args.arch, args.shape)]
    os.makedirs(args.out, exist_ok=True)
    card = card_bytes()
    status = 0
    for arch, shape in cells:
        tag = "multipod" if args.multi_pod else "pod"
        path = os.path.join(args.out, f"dryrun_{arch}_{shape}_{tag}.json")
        if os.path.exists(path):
            print(f"[skip] {arch} × {shape} ({tag}) — cached")
            continue
        try:
            rec = run_cell(arch, shape, args.multi_pod, card)
            gb = rec["memory"]["argument_size"] / 1e9
            fits = "" if card is None else (
                f" of {card / 1e9:.2f} GB: {'fits' if rec['fits_card'] else 'does not fit'}")
            print(f"[ok]   {arch} × {shape} ({tag}) {gb:.2f} GB a device{fits} "
                  f"model_flops={rec['model_flops']:.3e}", flush=True)
        except Exception as e:
            rec = dict(arch=arch, shape=shape,
                       mesh="2x16x16" if args.multi_pod else "16x16",
                       status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc())
            print(f"[FAIL] {arch} × {shape} ({tag}): {e}", flush=True)
            status = 1
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return status


if __name__ == "__main__":
    sys.exit(main())
