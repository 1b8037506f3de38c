"""Row-sharded embedding tables over a process group: the four recsys train
cells and dimenet's ``molecule`` on a 2 × 2 mesh of 4 gloo processes on
the CPU, spawned once for the module.

* One mesh step of each reduced cell, and of bert4rec's full train shape
  (65,536 sequences in 4 micro-batches) at the reduced width (f32
  compute on both sides, the reference's initial state and batch), is
  held to the reference's
  ``jax.jit(bundle.step_fn)`` without a mesh: the loss within 1e-4, every
  parameter and accumulator at ``rtol=1e-3, atol=1e-5`` (the bars of the
  reference's own ``tests/test_distribution.py``), the touched masks
  equal. The ranks' state is gathered to rank 0 as a save gathers it.
* The sharded row gather (``models.embedding.ShardedLookup``): its
  forward bit-equal to an unsharded take, its backward equal to the
  unsharded gradient, for a data-sharded and a replicated set of ids, a
  1-D table and the bf16 field lookup.
* Planted faults fail the step comparison: per-data-shard AdaGrad
  updates in dlrm-rm2's sparse step, and the replicated gradients summed
  over all 4 ranks instead of the data axis (xdeepfm).
* The launcher: reduced dlrm-rm2 through ``launch.train --mesh 2x2``, 4
  steps, saves every 2, a failure at 3, then the resume; the chain rank 0
  wrote restores in the reference package to the port's one-process
  restore, bit for bit, and within the 4-bit quantizer's error of the
  state rank 0 gathered for the last save; each rank's restored rows are
  bit-equal to the same rows of the one-process restore.
"""

import dataclasses
import json
import os
import pathlib
import pickle
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import _families as ref_families
from repro.configs import _module as ref_module
from repro.core import CheckNRunManager as RefManager
from repro.core import CheckpointConfig as RefConfig
from repro.core import LocalFSStore as RefStore
from repro.data import cells as ref_cells
from test_torch_mind import _to_numpy

RANKS = 4
ROOT = str(pathlib.Path(__file__).resolve().parents[1])
TIMEOUT = 240
# (tag, arch, shape, reduced shape): every config is the reduced one; the
# last cell takes bert4rec's full train shape (65,536 sequences, 4
# micro-batches, 256 negatives) at that width
CELLS = [("dlrm-rm2", "dlrm-rm2", "train_batch", True), ("xdeepfm", "xdeepfm", "train_batch", True),
         ("mind", "mind", "train_batch", True), ("bert4rec", "bert4rec", "train_batch", True),
         ("dimenet", "dimenet", "molecule", True),
         ("bert4rec-micro", "bert4rec", "train_batch", False)]
# 4 bits of a row: the adaptive quantizer's round trip read 0.086-0.125 of
# a row's largest entry at widths 64-6,144 (test_torch_quant_pack.py);
# twice its largest
QUANT_BAR = 0.25

_WORKER = textwrap.dedent("""
    import dataclasses, datetime, io, json, os, pickle, sys
    from contextlib import redirect_stdout
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, port, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from repro_torch.configs import _families, _module
        from repro_torch.core import CheckNRunManager, CheckpointConfig, LocalFSStore
        from repro_torch.dist.placement import Placement
        from repro_torch.dist.sharding import recsys_rules
        from repro_torch.launch import train
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import dlrm as m_dlrm
        from repro_torch.models import embedding as emb
        from repro_torch.train import loop, steps
        from repro_torch.train.loop import batch_to_device
        from repro_torch.train.state import state_from_numpy
        from repro_torch.tree import flatten_with_path, keystr

        mesh = make_host_mesh(2, 2)
        rec = dict(rank=rank)

        def bundle_of(arch, shape, reduced):
            cfg = dataclasses.replace(_module(arch).make_config(True),
                                      compute_dtype=torch.float32)
            build = _families.gnn_cell if arch == "dimenet" else _families.recsys_cell
            return build(arch, cfg, shape, reduced, "cpu", mesh=mesh)

        def step_once(cell, tag):
            name, arch, shape, reduced = cell
            b = bundle_of(arch, shape, reduced)
            rec.setdefault("n_micro", {})[tag] = getattr(b.step_fn, "n_micro", 1)
            pl = Placement(b, mesh)
            with open(os.path.join(d, f"{name}.state.pkl"), "rb") as f:
                state = pl.local_state(state_from_numpy(pickle.load(f), "cpu"))
            batch = dict(np.load(os.path.join(d, f"{name}.batch.npz")))
            state, metrics = b.step_fn(state, batch_to_device(pl.local_batch(batch), "cpu"))
            whole = pl.gather_state(state)
            if rank == 0:
                out = {k: v.numpy() for k, v in metrics.items() if v.dim() == 0}
                if not reduced:
                    # the port's own one-process step of the global batch
                    one = _families.recsys_cell(arch, b.cfg, shape, reduced, "cpu")
                    with open(os.path.join(d, f"{name}.state.pkl"), "rb") as f:
                        _, m = one.step_fn(state_from_numpy(pickle.load(f), "cpu"),
                                           batch_to_device(batch, "cpu"))
                    out["one_process_accuracy"] = m["accuracy"].numpy()
                for t in ("params", "opt_state", "touched"):
                    for path, v in flatten_with_path(getattr(whole, t)):
                        out[t + keystr(path)] = v.numpy()
                np.savez(os.path.join(d, f"{tag}.port.npz"), **out)
            return train.params_digest([leaf for path, leaf in flatten_with_path(state.params)
                                        if pl.param_is_replicated(path)])

        # (1) one step of each cell
        rec["digests"] = {cell[0]: step_once(cell, cell[0]) for cell in CELLS}

        # (2) planted faults: per-data-shard AdaGrad updates; sums over all ranks
        rows = m_dlrm.adagrad_rows

        def per_shard(table, acc, ids, g, lo, lr, eps):
            for i, g_i in zip(ids.chunk(2), g.chunk(2)):
                rows(table, acc, i, g_i, lo, lr, eps)

        m_dlrm.adagrad_rows = per_shard
        step_once(CELLS[0], "fault_per_shard")
        m_dlrm.adagrad_rows = rows
        sums = steps.sum_grads_by
        steps.sum_grads_by = lambda grads, group_of: sums(
            grads, lambda path: None if group_of(path) is None else mesh.group)
        step_once(CELLS[1], "fault_all_ranks")
        steps.sum_grads_by = sums

        # (3) the sharded gather against unsharded lookups
        gen = torch.Generator().manual_seed(5)
        V, D, B = 64, 8, 16
        table = torch.randn((V, D), generator=gen)
        bias = torch.randn((V,), generator=gen)
        ids = torch.randint(0, V, (B, 3), generator=gen)
        negs = torch.randint(0, V, (5,), generator=gen)
        w = torch.randn((B, 3, D), generator=gen)
        w_neg = torch.randn((2, 5, D), generator=gen)   # one a data shard
        fields = [torch.randn((V, D), generator=gen) for _ in range(3)]
        lk = emb.ShardedLookup(recsys_rules(mesh))
        i_d, lo, n = mesh.axis_index("data"), *lk.owned(V)
        rows_d = slice(i_d * B // 2, (i_d + 1) * B // 2)
        shard = table[lo:lo + n].clone().requires_grad_(True)
        got = lk.take(shard, lk.ids(ids[rows_d]), V)
        got_neg = lk.take(shard, lk.ids(negs, True), V)
        torch.autograd.backward([got, got_neg], [w[rows_d], w_neg[i_d]])
        want_t = table.clone().requires_grad_(True)
        torch.autograd.backward([emb.take(want_t, ids), emb.take(want_t, negs)],
                                [w, w_neg.sum(0)])
        got_b = lk.take(bias[lo:lo + n], lk.ids(ids[rows_d]), V)
        got_f = lk.fields([f[lo:lo + n] for f in fields], lk.ids(ids[rows_d, :, None]), [V] * 3)
        rec["gather"] = dict(
            forward=bool(torch.equal(got, emb.take(table, ids[rows_d]))),
            forward_replicated=bool(torch.equal(got_neg, emb.take(table, negs))),
            forward_1d=bool(torch.equal(got_b, emb.take(bias, ids[rows_d]))),
            forward_fields=bool(torch.equal(got_f, emb.take_fields(fields, ids[rows_d, :, None]))),
            backward_err=float((shard.grad - want_t.grad[lo:lo + n]).abs().max()),
            backward_scale=float(want_t.grad.abs().max()))

        # (4) the launcher: fail at 3, resume; rank 0 keeps the state it gathers
        gathered = []
        save = loop.MeshTrainer._state_to_save

        def keep(self):
            whole = save(self)
            if whole is not None:
                gathered.append({k: v.clone() for k, v in whole.params["tables"].items()})
            return whole

        loop.MeshTrainer._state_to_save = keep
        cmd = ["--arch", "dlrm-rm2", "--shape", "train_batch", "--steps", "4",
               "--interval", "2", "--bits", "4", "--device", "cpu", "--mesh", "2x2",
               "--ckpt-dir", os.path.join(d, "ckpt")]
        rcs, logs = [], []
        for extra in (["--fail-at", "3"], []):
            buf = io.StringIO()
            with redirect_stdout(buf):
                rcs.append(train.main(cmd + extra))
            logs.append(buf.getvalue())
        rec.update(rcs=rcs, logs=logs)
        if rank == 0:
            np.savez(os.path.join(d, "gathered.npz"),
                     **{k: v.numpy() for k, v in gathered[-1].items()})
        mgr = CheckNRunManager(LocalFSStore(os.path.join(d, "ckpt")),
                               CheckpointConfig(async_write=False, device="cpu"))
        part = mgr.restore_part(rank, num_hosts=world)
        mgr.close()
        np.savez(os.path.join(d, f"part{rank}.npz"),
                 **{k: v for k, v in part.tables.items()},
                 **{f"{k}/{a}": v for k, s in part.row_state.items() for a, v in s.items()})
        rec["ranges"] = part.extra["shard"]["row_range"]
        print(json.dumps(rec))
    finally:
        dist.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ref_bundle(arch, shape, reduced):
    cfg = dataclasses.replace(ref_module(arch).make_config(True), compute_dtype=jnp.float32)
    build = ref_families.gnn_cell if arch == "dimenet" else ref_families.recsys_cell
    return build(arch, cfg, shape, None, reduced)


def _ref_step(name, arch, shape, reduced, d):
    """The reference's one step without a mesh, flattened as the ranks
    write theirs."""
    bundle = _ref_bundle(arch, shape, reduced)
    state = bundle.make_state(jax.random.key(0))
    batch = dict(np.load(d / f"{name}.batch.npz"))
    state, metrics = jax.jit(bundle.step_fn)(state, batch)
    out = {k: np.asarray(v) for k, v in metrics.items() if np.ndim(v) == 0}
    for tag, tree in (("params", state.params), ("opt_state", state.opt_state),
                      ("touched", state.touched)):
        for path, v in jax.tree_util.tree_leaves_with_path(tree):
            out[tag + jax.tree_util.keystr(path)] = np.asarray(v)
    return out


def _mismatches(port, ref, skip=()):
    """The keys where ``port`` misses ``ref`` at the bars."""
    assert sorted(port) == sorted(ref), (sorted(port), sorted(ref))
    bad = []
    for k in ref:
        if k in skip:
            continue
        if k.startswith("touched"):
            ok = np.array_equal(port[k], ref[k])
        elif k in ("loss", "accuracy", "mae"):
            ok = abs(float(port[k]) - float(ref[k])) < (1e-4 if k == "loss" else 1e-6)
        else:
            ok = np.allclose(port[k], ref[k], rtol=1e-3, atol=1e-5)
        if not ok:
            bad.append(k)
    return bad


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4 ranks, and the reference's one-device steps while they run."""
    d = tmp_path_factory.mktemp("mesh_recsys")
    for name, arch, shape, reduced in CELLS:
        bundle = _ref_bundle(arch, shape, reduced)
        with open(d / f"{name}.state.pkl", "wb") as f:
            pickle.dump(_to_numpy(bundle.make_state(jax.random.key(0))), f)
        np.savez(d / f"{name}.batch.npz",
                 **{k: np.asarray(v) for k, v in ref_cells.batch_for_cell(bundle, 1).items()})
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    port = str(_free_port())
    code = f"CELLS = {CELLS!r}\n" + _WORKER
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(RANKS), port, str(d)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=ROOT)
             for r in range(RANKS)]
    try:
        ref = {cell[0]: _ref_step(*cell, d) for cell in CELLS}
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return dict(d=d, ref=ref, ranks=[json.loads(o.strip().splitlines()[-1]) for o, _ in outs])


@pytest.mark.parametrize("name", [c[0] for c in CELLS])
def test_one_mesh_step_matches_reference(runs, name):
    """The ranks' step, gathered, against the reference's one-device step;
    the replicated parameters bit-equal on every rank. ``bert4rec-micro``
    runs 4 micro-batches, each rank its slice of each, each micro-batch's
    masked mean over its global mask count, as the reference's scan."""
    port = dict(np.load(runs["d"] / f"{name}.port.npz"))
    skip = ()
    if name == "bert4rec-micro":
        # over 65,536 x 16 positions a few argmax near-ties fall the other
        # way between the packages' f32 logits, one process or many (0.02176
        # against the port's 0.02165 in one process): the accuracy is held
        # to the port's one-process step of the same batch
        one = port.pop("one_process_accuracy")
        assert abs(float(port["accuracy"]) - float(one)) < 1e-6, (port["accuracy"], one)
        skip = ("accuracy",)
    assert _mismatches(port, runs["ref"][name], skip) == []
    assert len({r["digests"][name] for r in runs["ranks"]}) == 1
    assert runs["ranks"][0]["n_micro"][name] == (4 if name == "bert4rec-micro" else 1)


@pytest.mark.parametrize("tag,arch", [("fault_per_shard", "dlrm-rm2"),
                                      ("fault_all_ranks", "xdeepfm")])
def test_planted_faults_fail_the_step_comparison(runs, tag, arch):
    """Two half-updates of a row's AdaGrad are not one: the tables miss
    (their accumulators, a mean of squared gradients near 1e-6, lie inside
    the 1e-5 atol); a sum over the model axis too doubles the replicated
    gradients: AdaGrad's first step is scale-free but for its eps, so the
    dense accumulators miss (and the rows whose gradient is near eps)."""
    port = dict(np.load(runs["d"] / f"{tag}.port.npz"))
    bad = _mismatches(port, runs["ref"][arch])
    if tag == "fault_per_shard":
        assert any(k.startswith("params['tables']") for k in bad), bad
    else:
        assert any(k.startswith("opt_state['dense']") for k in bad), bad


def test_sharded_gather_is_exact(runs):
    """Forward bit-equal to the unsharded take (data-sharded ids,
    replicated ids, a 1-D table, the bf16 fields); backward, the rank's
    rows of the unsharded gradient of every data shard's cotangent."""
    for r in runs["ranks"]:
        g = r["gather"]
        assert g["forward"] and g["forward_replicated"] and g["forward_1d"], g
        assert g["forward_fields"], g
        assert g["backward_err"] <= 1e-6 * g["backward_scale"], g


def test_launcher_trains_dlrm_on_the_mesh_through_a_failure(runs):
    """Each rank: the failure at 3 returns 2, the rerun resumes from step
    2 and finishes; rank 0's log names the resume, the restored rows'
    check and the gathers; only rank 0 prints."""
    for r in runs["ranks"]:
        assert r["rcs"] == [2, 0], r
    first, second = runs["ranks"][0]["logs"]
    assert "injected failure at step 3" in first
    assert "resumed from checkpoint at step 2" in second
    assert "restored rows of 4 ranks bit-equal to the one-process restore of step 2" in second
    assert "parameters bit-equal after every step and the restore" in second
    assert "to rank 0 a save" in second
    assert all(not any(r["logs"]) for r in runs["ranks"][1:])


def test_chain_restores_in_reference_and_by_rank(runs):
    """The chain's last step restored by the reference package equals the
    port's one-process restore bit for bit, and lies within the 4-bit
    quantizer's error of the tables rank 0 gathered for that save; each
    rank's range read equals its rows of the one-process restore."""
    from repro_torch.core import CheckNRunManager, CheckpointConfig, LocalFSStore

    path = str(runs["d"] / "ckpt")
    ref_mgr = RefManager(RefStore(path), RefConfig(async_write=False))
    port_mgr = CheckNRunManager(LocalFSStore(path), CheckpointConfig(async_write=False,
                                                                     device="cpu"))
    try:
        a, b = ref_mgr.restore(), port_mgr.restore()
    finally:
        ref_mgr.close()
        port_mgr.close()
    assert a.step == b.step == 4 and sorted(a.tables) == sorted(b.tables)
    gathered = dict(np.load(runs["d"] / "gathered.npz"))
    for name in a.tables:
        np.testing.assert_array_equal(a.tables[name], b.tables[name], err_msg=name)
        np.testing.assert_array_equal(a.row_state[name]["opt_acc"],
                                      b.row_state[name]["opt_acc"], err_msg=name)
        want = gathered[name]
        err = np.abs(a.tables[name] - want).max(axis=1) / np.abs(want).max(axis=1)
        assert err.max() <= QUANT_BAR, (name, err.max())
    for rank, r in enumerate(runs["ranks"]):
        part = dict(np.load(runs["d"] / f"part{rank}.npz"))
        for name, (lo, hi) in r["ranges"].items():
            np.testing.assert_array_equal(part[name], b.tables[name][lo:hi], err_msg=name)
            np.testing.assert_array_equal(part[f"{name}/opt_acc"],
                                          b.row_state[name]["opt_acc"][lo:hi], err_msg=name)
