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
card). The reference's compiled ``flops`` are absent: the port has no
compiler to read them from.

``collectives`` has the reference's shape (per-type operand bytes, ring
``wire`` bytes, ``counts``, ``total``, ``wire_total``), counted from the
calls the port's code makes (``count_collectives``): the code runs on the
meta device over a recording mesh (``launch.mesh.make_recording_mesh``,
whose groups move nothing) and ``dist.group_ops`` records each call, as
it does over a real group. Counted: dimenet's flat-graph cells, whose
train step runs the sharded forward and backward and sums the gradients
(one device's whole step); the four recsys train cells and dimenet's
``molecule``, whose step runs on one rank's part of the state and the
batch (``dist.placement``): the row-sharded tables' exchange, the loss's
sums, the replicated gradients' sum (one device's whole step; the
reference's collectives are GSPMD's, which XLA chooses); the five LM
``train_4k`` cells, whose tensor- and sequence-parallel step runs on one
rank's blocks (its collectives forward, recomputed and backward, and the
gradients' sums; the count's formula is ``count_collectives``'); and the
LM prefill and decode cells whose MoE resolves to expert-parallel
dispatch, where ``models.layers._moe_ep``'s are the only collectives on a
group. Serving otherwise ignores the mesh: ``collectives`` is null there,
``collectives_note`` says why.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dlrm-rm2 --shape train_batch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results/]
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Optional

import numpy as np
import torch

from ..configs import all_cells, arch_family, get_cell
from ..configs._families import InputSpec
from ..dist.group_ops import recording
from ..dist.placement import Placement
from ..dist.sharding import PartitionSpec
from ..models import dimenet as m_dimenet
from ..models.layers import moe_dispatch, moe_ffn
from ..tree import flatten_with_path, keystr
from .mesh import Mesh, make_production_mesh, make_recording_mesh

NOT_YET = "the compiled flops: the port has no compiler to read them from"


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


def step_collectives(bundle, state, batch) -> dict:
    """The collectives of one ``bundle.step_fn(state, batch)``, as this
    rank issues them."""
    with recording() as rec:
        bundle.step_fn(state, batch)
    return rec.summary()


def moe_collectives(bundle, mesh: Mesh, device="meta") -> dict:
    """``_moe_ep``'s collectives of one rank of ``mesh`` over an LM serving
    cell's step (serving ignores the mesh but for the MoE's expert-parallel
    dispatch): every layer's MoE forward on the rank's token shard, the
    rank holding the router and its experts, as ``_moe_ep`` takes them. On
    ``meta`` over a recording mesh nothing is computed; over a host mesh on
    another device the layers run on random inputs and their collectives
    move. (A train cell's step is ``lm_step_collectives``'.)"""
    from ..models.layers import act_fn

    cfg = bundle.cfg
    moe, d, L = cfg.moe, cfg.d_model, cfg.n_layers
    tok = bundle.make_inputs()["tokens"]
    b_l, s = shard_shape(tok.shape, bundle.input_pspecs["tokens"], mesh)
    e_l = moe.n_experts // mesh.shape["model"]
    fsdp = bundle.rules.axes_for("d_model", d) or ()
    d_l = d // math.prod(mesh.shape[a] for a in fsdp)
    gen = torch.Generator().manual_seed(0)

    def draw(*shape):
        if device == "meta":
            return torch.empty(shape, device="meta")
        return (0.05 * torch.randn(shape, generator=gen)).to(device)

    with recording() as rec, torch.no_grad():
        for _ in range(L):
            params = dict(router=draw(d, moe.n_experts), w_up=draw(e_l, d_l, moe.d_ff),
                          w_down=draw(e_l, moe.d_ff, d_l))
            if moe.gated:
                params["w_gate"] = draw(e_l, d_l, moe.d_ff)
            moe_ffn(draw(b_l, s, d).to(cfg.compute_dtype), params, moe, act=act_fn(cfg.act),
                    compute_dtype=cfg.compute_dtype, rules=bundle.rules)
    return rec.summary()


_LM_COUNTS: dict = {}   # count_collectives' LM train counts, by what they depend on


def lm_step_collectives(bundle, mesh: Mesh, reduced: bool = False,
                        global_batch: Optional[int] = None) -> dict:
    """One rank's collectives of an LM train cell's whole step on the
    recording ``mesh``: its part of the state and the batch
    (``dist.placement``) through ``bundle.step_fn`` on the meta device. The
    layers are alike, so a cell of L > 2 layers is counted at 1 and 2 and
    each figure taken as c1 + (L − 1)·(c2 − c1): exact, as every layer
    issues the same calls and the gradients' sums carry (L, ...) stacks."""
    from ..configs._families import lm_cell

    cfg = bundle.cfg

    def at(n_layers):
        b = bundle if n_layers == cfg.n_layers else lm_cell(
            bundle.arch, dataclasses.replace(cfg, n_layers=n_layers), bundle.shape,
            reduced, "meta", global_batch, mesh=mesh)
        pl = Placement(b, mesh)
        return step_collectives(b, pl.local_state(b.state_shapes()),
                                pl.local_batch(meta_inputs(b.make_inputs())))

    if cfg.n_layers <= 2:
        return at(cfg.n_layers)
    c1, c2 = at(1), at(2)

    def extend(a, b):
        if isinstance(a, dict):
            return {k: extend(a[k], b[k]) for k in a}
        return a + (cfg.n_layers - 1) * (b - a)

    return extend(c1, c2)


def count_collectives(arch: str, shape: str, mesh: Mesh, reduced: bool = False,
                      global_batch: Optional[int] = None):
    """(collectives, note): one device's collectives of the cell's step on
    ``mesh`` (``dist.group_ops.collective_bytes``' shape) and what they cover, or
    (None, why) for a cell the port runs on no group. ``global_batch``
    replaces the cell's batch (``configs.get_cell``).

    An LM ``train_4k`` cell (``lm_step_collectives``) on a mesh whose
    ``model`` axis divides the sequence (sequence parallelism, every
    production and card mesh) issues, with D, M the axes' sizes, n_micro
    micro-batches, L layers and n_c = S / 512 cross-entropy chunks, per
    micro-batch:
      * ``tok_emb``: row-sharded (V divides D·M), an all-gather of the ids,
        a reduce-scatter of the rows and an all-gather of their cotangents,
        over the world; replicated, an all-gather of the ids over ``data``
        (none at D = 1);
      * a layer, whose forward checkpointing runs again in the backward up
        to the last tensor the backward needs (so a block's final
        reduce-scatter, and the MoE's sums after it, are not run again):
        attention (or MLA) with heads split, 3 all-gathers and 3
        reduce-scatters over ``model`` (forward, again, backward), with
        heads whole 2 all-gathers and 1 reduce-scatter; a dense FFN with
        ff split 3 all-gathers and 2 reduce-scatters, whole none; an
        expert-parallel MoE 3 all-gathers, 2 reduce-scatters and 2
        all-reduces (the touched masks and the aux losses, forward only);
      * the cross-entropy: vocabulary split, an all-gather of the hidden
        states and its reduce-scatter backward, and a chunk 2 all-gathers
        of the logsumexps (forward and again) and 1 all-reduce of the gold
        logits, then 1 all-reduce over ``data`` (none at D = 1);
        vocabulary whole, 1 all-reduce over the world;
    and once a step, one all-reduce of the gradients a group that sums any
    (``configs._families.lm_grad_axes``: ``data``, the world)."""
    rec_mesh = make_recording_mesh(mesh)
    bundle = get_cell(arch, shape, device="meta", mesh=rec_mesh, reduced=reduced,
                      global_batch=global_batch)
    family = arch_family(arch)
    if family == "gnn" and m_dimenet._use_sharded(bundle.make_inputs(), bundle.cfg,
                                                  bundle.rules):
        coll = step_collectives(bundle, bundle.state_shapes(),
                                meta_inputs(bundle.make_inputs()))
        return coll, ("the train step: the sharded forward and backward "
                      "(models.dimenet.forward_flat_sharded) and the gradients' sum")
    if bundle.kind == "train" and family == "lm":
        # lm_rules split nothing over a pod axis: no group's size depends on it
        key = (arch, shape, reduced, global_batch, mesh.shape.get("data"),
               mesh.shape.get("model"))
        if key not in _LM_COUNTS:
            _LM_COUNTS[key] = lm_step_collectives(bundle, rec_mesh, reduced, global_batch)
        return copy.deepcopy(_LM_COUNTS[key]), (
            "the train step of one rank: the tensor-parallel blocks' sequence gathers and "
            "reduce-scatters over model (dist.tensor_parallel), the row-sharded tok_emb's "
            "exchange, the vocabulary-parallel cross-entropy's sums, the expert-parallel "
            "MoE's, forward, the forward again where torch.utils.checkpoint recomputes it, "
            "and backward, and the gradients' sums; the reference's collectives are "
            "GSPMD's, which XLA chooses, not this count")
    if bundle.kind == "train" and (family == "recsys" or shape == "molecule"):
        pl = Placement(bundle, rec_mesh)
        coll = step_collectives(bundle, pl.local_state(bundle.state_shapes()),
                                pl.local_batch(meta_inputs(bundle.make_inputs())))
        return coll, ("the train step of one rank: its data shard of the batch, the "
                      "row-sharded tables' exchange (models.embedding.ShardedLookup) "
                      "forward and backward, the loss's sums and the replicated "
                      "gradients' sum; the reference's collectives are GSPMD's, which "
                      "XLA chooses, not this count")
    if (family == "lm" and bundle.cfg.moe is not None
            and moe_dispatch(bundle.cfg.moe, bundle.rules) == "ep"):
        coll = moe_collectives(bundle, rec_mesh)
        return coll, (f"models.layers._moe_ep over the {bundle.cfg.n_layers} MoE layers, "
                      "forward; serving ignores the mesh but for the MoE's expert-parallel "
                      "dispatch (GSPMD's collectives in the reference)")
    return None, ("the reference's collectives here are what GSPMD inserts; the port "
                  "runs only the train cells on a process group: serving ignores the "
                  "mesh, as the reference's does")


def run_cell(arch: str, shape: str, multi_pod: bool,
             card: Optional[int] = None) -> dict:
    t0 = time.monotonic()
    mesh = make_production_mesh(multi_pod=multi_pod)
    bundle = get_cell(arch, shape, device="meta", mesh=mesh)
    split = argument_bytes(bundle, mesh)
    arg = sum(split.values())
    coll, note = count_collectives(arch, shape, mesh)
    return dict(
        arch=arch, shape=shape, kind=bundle.kind,
        mesh="2x16x16" if multi_pod else "16x16",
        n_devices=mesh.size,
        memory=dict(argument_size=arg, argument_split=split),
        model_flops=bundle.model_flops,
        card_bytes=card,
        fits_card=None if card is None else arg <= card,
        collectives=coll,
        collectives_note=note,
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
            coll = rec["collectives"]
            wire = ("" if coll is None else
                    f" collectives {coll['total'] / 1e6:.3f} MB "
                    f"({coll['wire_total'] / 1e6:.3f} MB on the wire) a device")
            print(f"[ok]   {arch} × {shape} ({tag}) {gb:.2f} GB a device{fits} "
                  f"model_flops={rec['model_flops']:.3e}{wire}", flush=True)
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
