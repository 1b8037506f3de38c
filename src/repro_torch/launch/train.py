"""Training launcher CLI.

  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch ARCH \
      --shape SHAPE --steps 100 --interval 20 --bits 4 \
      --policy intermittent --ckpt-dir CKPT_DIR [--reduced | --full-config] \
      [--vocab-cap ROWS] [--layers N] [--global-batch B] [--fail-at 60] \
      [--device cuda|cpu] [--mesh DATAxMODEL]

ARCH is any arch of the registry: xdeepfm, dlrm-rm2, mind, bert4rec
(recsys), dimenet (gnn), qwen2-0.5b, nemotron-4-15b, olmoe-1b-7b,
dbrx-132b or minicpm3-4b (LM). SHAPE is a train shape of the arch's
family: ``train_batch`` (recsys),
``molecule``, ``full_graph_sm``, ``minibatch_lg`` or ``ogb_products``
(dimenet), ``train_4k`` (the LMs).

Runs on the card (``--device cuda``, the default) and raises when there is
none; ``--device cpu`` runs the same path on the CPU. ``--layers`` keeps an
LM's first N layers (its widths stay), ``--global-batch`` replaces the
shape's batch (an LM or recsys train cell's): cuts for one card.

``--mesh DATAxMODEL`` runs this process as one of DATA·MODEL ranks of a
(data, model) mesh (``launch.mesh.make_host_mesh``), e.g.

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch dlrm-rm2 \
      --shape train_batch --mesh 2x2 --ckpt-dir CKPT_DIR ...

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch qwen2-0.5b \
      --shape train_4k --mesh 2x2 --ckpt-dir CKPT_DIR ...

It takes the process group already initialised, or initialises a gloo
group from ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``.
Rank r runs on ``cuda:(r % device_count)``. The mesh takes:
  * dimenet's flat-graph cells (``full_graph_sm``, ``minibatch_lg``,
    ``ogb_products``) whose batch shards over it: every rank draws the
    same batches, runs the sharded forward on its ranges and sums the
    ranks' gradients in one all-reduce;
  * the recsys train cells (``train_batch``) and dimenet's ``molecule``:
    each rank holds its rows of every table whose rows divide the mesh
    (with their accumulators and touched masks; ``dist.placement``) and
    trains on its data shard of the batch (``models.embedding.
    ShardedLookup``), the replicated leaves' gradients summed over
    ``data``. At a save the row-sharded state is gathered to rank 0, and a
    restore reads each rank's own rows, held bit-equal to the same rows of
    a one-process restore of the chain;
  * the five LM cells' ``train_4k`` (qwen2-0.5b, nemotron-4-15b,
    olmoe-1b-7b, dbrx-132b, minicpm3-4b): tensor-parallel attention, MLA,
    FFN and experts over ``model``, the residual sequence-parallel, a
    vocabulary-parallel cross-entropy, ``tok_emb``'s rows over the mesh
    where they divide it (``dist.tensor_parallel``,
    ``models.transformer.train_loss``); each rank holds its blocks
    (``dist.placement``), made leaf by leaf; saves gather them to rank 0,
    and a restore reads each rank's rows of ``tok_emb`` and of the expert
    blocks (one range a layer).
One rank (rank 0) writes the one checkpoint chain and every rank restores
from it; after every step and the restore each leaf is checked bit-equal
across the ranks that hold the same block of it: a replicated one over
every rank, one split over ``model`` alone over ``data``. Refused with
``ValueError`` before any group opens, so that no cell trains on one
device in the mesh's place: a mesh spec that does not parse, a serving
shape, and a config with ``pure_fsdp_train`` (the port has no pure-FSDP
step; no registered config sets it).
"""

from __future__ import annotations

import argparse
import hashlib
import sys


def _parse_mesh(spec: str):
    try:
        d, m = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes DATAxMODEL, e.g. 2x2; got {spec!r}") from None
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {spec!r}: each axis holds at least one rank")
    return d, m


def _refuse(arch: str, shape: str, why: str):
    return ValueError(
        f"--mesh: {arch} {shape} {why}; the port trains on a mesh the recsys train "
        "cells, dimenet's molecule and its flat-graph cells whose batch shards over "
        "it, and the five LM train_4k cells (tensor- and sequence-parallel)")


def join_mesh(spec: str, arch: str, shape: str, device: str, reduced: bool = True):
    """(mesh, this rank's device, whether this call opened the group) for
    ``--mesh``. Refuses a cell the port cannot run on a group before it
    touches one."""
    import torch
    import torch.distributed as dist

    from ..configs import _module, arch_family
    from ..configs.shapes import FAMILY_SHAPES
    from .mesh import make_host_mesh

    d, m = _parse_mesh(spec)
    family = arch_family(arch)
    kind = FAMILY_SHAPES[family].get(shape, {}).get("kind")
    if kind != "train":
        raise _refuse(arch, shape, f"is a {kind} shape, and the mesh trains" if kind
                      else "is no shape of its family")
    if family == "lm" and _module(arch).make_config(reduced).pure_fsdp_train:
        raise _refuse(arch, shape, "sets pure_fsdp_train: the port has no pure-FSDP step "
                      "(minicpm3-4b's attempt was refuted in the reference)")
    opened = not dist.is_initialized()
    if opened:
        dist.init_process_group("gloo")
    if dist.get_world_size() != d * m:
        raise ValueError(f"--mesh {spec} needs {d * m} ranks; the group holds "
                         f"{dist.get_world_size()}")
    mesh = make_host_mesh(d, m)
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        device = f"cuda:{dist.get_rank() % torch.cuda.device_count()}"
    return mesh, device, opened


def params_digest(params) -> str:
    """SHA-256 of every parameter's bytes, in tree order."""
    import torch

    from ..tree import flatten_with_path

    h = hashlib.sha256()
    for _, leaf in flatten_with_path(params):
        h.update(leaf.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def check_replicas(params, mesh, what: str, group=None) -> None:
    """Raise unless every rank of ``group`` (default: all of ``mesh``'s)
    holds bit-equal ``params`` (a tree, or a list of leaves)."""
    import torch.distributed as dist

    from ..dist.group_ops import group_size

    group = mesh.group if group is None else group
    mine = params_digest(params)
    every = [None] * group_size(group)
    dist.all_gather_object(every, mine, group=group)
    if len(set(every)) != 1:
        raise RuntimeError(f"the ranks' parameters differ {what}: {every}")


def _held_alike(placement, mesh):
    """[(group, leaves of a params tree → list)]: the leaves every rank
    holds whole, over the mesh's group; the leaves split over ``model``
    alone, over ``data`` (its ranks hold the same block)."""
    from ..tree import flatten_with_path, keystr

    specs = {keystr(p): s for p, s in flatten_with_path(placement.specs.params)}

    def axes(path):
        s = specs[keystr(path)]
        return {a for e in s if e is not None for a in (e if isinstance(e, tuple) else (e,))}

    def pick(want):
        return lambda params: [leaf for path, leaf in flatten_with_path(params)
                               if want(axes(path))]

    out = [(None, pick(lambda a: not a))]
    if "model" in mesh.shape and any(axes(p) == {"model"} for p, _ in
                                     flatten_with_path(placement.specs.params)):
        out.append((mesh.group_for(("data",)), pick(lambda a: a == {"model"})))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="xdeepfm, dlrm-rm2, mind, bert4rec, dimenet, qwen2-0.5b, "
                         "nemotron-4-15b, olmoe-1b-7b, dbrx-132b or minicpm3-4b")
    ap.add_argument("--shape", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--interval", type=int, default=20)
    ap.add_argument("--policy", default="intermittent",
                    choices=["full_only", "one_shot", "consecutive", "intermittent"])
    ap.add_argument("--bits", type=int, default=4, choices=[0, 2, 3, 4, 8],
                    help="0 = no quantization")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full-config", dest="reduced", action="store_false")
    ap.add_argument("--vocab-cap", type=int, default=None,
                    help="cap every embedding table at this many rows")
    ap.add_argument("--layers", type=int, default=None,
                    help="an LM's depth cut to its first N layers")
    ap.add_argument("--global-batch", type=int, default=None,
                    help="the shape's global batch replaced (LM and recsys train cells)")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL, e.g. 2x2: one rank of a (data, model) mesh")
    ap.add_argument("--n-nodes", type=int, default=1)
    ap.add_argument("--p-fail", type=float, default=0.0)
    ap.add_argument("--train-hours", type=float, default=24.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mesh, device, opened = None, args.device, False
    if args.mesh:
        mesh, device, opened = join_mesh(args.mesh, args.arch, args.shape, args.device,
                                         args.reduced)
    try:
        return _train(args, mesh, device)
    finally:
        if opened:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(args, mesh, device):
    import dataclasses

    from ..configs import _module, arch_family, get_cell
    from ..configs._families import lm_cell
    from ..core import CheckpointConfig, InMemoryStore, LocalFSStore, PAPER_DEFAULTS
    from ..core.bitwidth import BitwidthController
    from ..dist.placement import Placement
    from ..models import dimenet
    from ..train.loop import MeshTrainer, SimulatedFailure, Trainer, TrainerConfig

    if args.layers is not None:
        if arch_family(args.arch) != "lm":
            raise ValueError(f"--layers cuts an LM's depth; {args.arch} is no LM")
        cfg = dataclasses.replace(_module(args.arch).make_config(args.reduced),
                                  n_layers=args.layers)
        bundle = lm_cell(args.arch, cfg, args.shape, args.reduced, device,
                         args.global_batch, mesh=mesh)
    else:
        bundle = get_cell(args.arch, args.shape, reduced=args.reduced, device=device,
                          vocab_cap=args.vocab_cap, global_batch=args.global_batch, mesh=mesh)
    rank0, placement = True, None
    alike = [(None, lambda params: params)]

    def check_alike(params, what):
        for group, leaves in alike:
            check_replicas(leaves(params), mesh, what, group)

    if mesh is not None:
        import torch.distributed as dist

        if "features" in bundle.make_inputs():
            if not dimenet._use_sharded(bundle.make_inputs(), bundle.cfg, bundle.rules):
                raise _refuse(args.arch, args.shape,
                              f"({bundle.make_inputs()['features'].shape[0]} nodes) does "
                              f"not shard over {mesh!r}")
        else:
            placement = Placement(bundle, mesh)
            alike = _held_alike(placement, mesh)
        rank0 = dist.get_rank() == 0
        step = bundle.step_fn

        def checked_step(state, batch):
            state, metrics = step(state, batch)
            check_alike(state.params, f"after step {state.step}")
            return state, metrics

        bundle.step_fn = checked_step

    store = LocalFSStore(args.ckpt_dir) if args.ckpt_dir else InMemoryStore()
    bitwidth = None
    if args.p_fail > 0:
        bitwidth = BitwidthController(args.n_nodes, args.p_fail, args.train_hours)
        if rank0:
            print(f"dynamic bit-width: E[failures]={bitwidth.estimate:.2f} → "
                  f"{bitwidth.bits}-bit")
    quant = None if args.bits == 0 else PAPER_DEFAULTS[args.bits]
    ckpt = CheckpointConfig(interval_batches=args.interval, policy=args.policy,
                            quant=quant, async_write=True, device=device)
    tcfg = TrainerConfig(total_steps=args.steps, log_every=10, writes_checkpoints=rank0)
    if placement is not None:
        trainer = MeshTrainer(bundle, store, ckpt, tcfg, placement, bitwidth=bitwidth)
    else:
        trainer = Trainer(bundle, store, ckpt, tcfg, bitwidth=bitwidth)
    if mesh is not None:
        dist.barrier(group=mesh.group)   # the writer's earlier saves are committed
    start = trainer.init_or_restore()
    if mesh is not None:
        check_alike(trainer.state.params, f"after the restore at {start}")
    if start and rank0 and placement is not None:
        print(f"restored rows of {mesh.size} ranks bit-equal to the one-process restore "
              f"of step {trainer.restored_rows_checked}")
    if start and rank0:
        print(f"resumed from checkpoint at step {start}")
    try:
        trainer.run(args.steps - start, fail_at_step=args.fail_at)
    except SimulatedFailure as e:
        if rank0:
            print(f"!! {e} — rerun this command to resume from the checkpoint")
        trainer.close()
        if mesh is not None:
            dist.barrier(group=mesh.group)
        return 2
    trainer.manager.wait()
    if mesh is not None:
        dist.barrier(group=mesh.group)
        if rank0:
            print(f"mesh {args.mesh}: {mesh.size} ranks, parameters bit-equal after "
                  f"every step and the restore")
            if placement is not None and trainer.gather_s:
                print(f"gathered {placement.gathered_bytes(trainer.state) / 1e6:.2f}"
                      f" MB to rank 0 a save: " + ", ".join(
                          f"{t:.3f}" for t in trainer.gather_s) + " s")
    if rank0:
        for m in trainer.history:
            print("  " + "  ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                                   for k, v in m.items()))
        stats = store.counters.snapshot()
        print(f"checkpoint bytes written: {stats['bytes_written']/1e6:.2f} MB "
              f"({stats['put_ops']} objects)")
    trainer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
