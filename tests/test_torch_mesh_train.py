"""Training on a mesh through ``launch/train.py --mesh``, the dry run's
``collectives`` (and its count for reduced dlrm-rm2 against one step's
calls over gloo), and ``core.tracker.init_touched``'s device.

The launcher runs dimenet's reduced ``full_graph_sm`` (128 nodes, 512
edges, 2,048 triplets: 32 nodes a rank) on a 2 × 2 mesh of 4 gloo
processes on the CPU, each calling ``launch.train.main`` as ``torchrun``
would, in the group the process opened: 4 steps with saves every 2 and a
failure at 3, then the same command, which resumes from the one chain
rank 0 wrote; the launcher holds the ranks' parameters bit-equal after
every step and the restore, and that check is shown to fail on a planted
difference. One step of the cell's ``step_fn`` on the mesh (f32 compute,
the reference's initial state, the batch without its self-loops: the
reference's gradient is NaN at a self-loop, ROADMAP C) is held to the
reference's ``jax.jit(bundle.step_fn)`` on its own 2 × 2 mesh of emulated
devices: the loss, the accuracy, every new parameter and every adagrad
accumulator.
"""

import json
import os
import pathlib
import pickle
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_cell as ref_get_cell
from repro.data import cells as ref_cells
from repro_torch.configs import all_cells, arch_family
from repro_torch.dist.group_ops import COLLECTIVE_OPS
from repro_torch.launch import dryrun, train
from repro_torch.launch.mesh import Mesh, make_production_mesh
from test_torch_dimenet import _without_self_loops
from test_torch_mind import _to_numpy

RANKS = 4
ROOT = str(pathlib.Path(__file__).resolve().parents[1])
TIMEOUT = 240
TABLE = pathlib.Path(__file__).with_name("dryrun_collectives.json")
EP_ARCHS = ("olmoe-1b-7b", "dbrx-132b")

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, pickle
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import _families, dimenet

    d = sys.argv[1]
    batch = {k: jnp.asarray(v) for k, v in np.load(os.path.join(d, "batch.npz")).items()}
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    cfg = dataclasses.replace(dimenet.make_config(True), compute_dtype=jnp.float32)
    bundle = _families.gnn_cell("dimenet", cfg, "full_graph_sm", mesh, True)
    with mesh:
        state, metrics = jax.jit(bundle.step_fn)(bundle.make_state(jax.random.key(0)), batch)
    out = {"loss": np.asarray(metrics["loss"]), "accuracy": np.asarray(metrics["accuracy"])}
    for tag, tree in (("params", state.params), ("opt_state", state.opt_state)):
        for path, v in jax.tree_util.tree_leaves_with_path(tree):
            out[tag + jax.tree_util.keystr(path)] = np.asarray(v)
    np.savez(os.path.join(d, "ref.npz"), **out)
    print("OK")
""")

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
        from repro_torch.configs import _families, dimenet
        from repro_torch.launch import train
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.train.loop import batch_to_device
        from repro_torch.train.state import state_from_numpy
        from repro_torch.tree import flatten_with_path, keystr

        cmd = ["--arch", "dimenet", "--shape", "full_graph_sm", "--steps", "4",
               "--interval", "2", "--bits", "4", "--device", "cpu", "--mesh", "2x2",
               "--ckpt-dir", os.path.join(d, "ckpt")]
        rcs, logs = [], []
        for extra in (["--fail-at", "3"], []):
            buf = io.StringIO()
            with redirect_stdout(buf):
                rcs.append(train.main(cmd + extra))
            logs.append(buf.getvalue())
        mesh = make_host_mesh(2, 2)
        try:
            train.check_replicas({"w": torch.full((3,), float(rank == 3))}, mesh, "planted")
            planted = "not raised"
        except RuntimeError as e:
            planted = str(e)
        # one f32 step of the cell's step_fn from the reference's state
        cfg = dataclasses.replace(dimenet.make_config(True), compute_dtype=torch.float32)
        bundle = _families.gnn_cell("dimenet", cfg, "full_graph_sm", reduced=True,
                                    device="cpu", mesh=mesh)
        with open(os.path.join(d, "state.pkl"), "rb") as f:
            state = state_from_numpy(pickle.load(f), "cpu")
        batch = batch_to_device(dict(np.load(os.path.join(d, "batch.npz"))), "cpu")
        state, metrics = bundle.step_fn(state, batch)
        # one reduced dlrm-rm2 step on the rank's part, its calls recorded
        from repro_torch.configs import get_cell
        from repro_torch.data.cells import batch_for_cell
        from repro_torch.dist.group_ops import recording
        from repro_torch.dist.placement import Placement

        dlrm = get_cell("dlrm-rm2", "train_batch", reduced=True, device="cpu", mesh=mesh)
        pl = Placement(dlrm, mesh)
        with recording() as r:
            dlrm.step_fn(pl.local_state(dlrm.make_state()),
                         batch_to_device(pl.local_batch(batch_for_cell(dlrm, 0)), "cpu"))
        dlrm_calls = r.summary()
        out = {"loss": metrics["loss"].numpy(), "accuracy": metrics["accuracy"].numpy()}
        for tag, tree in (("params", state.params), ("opt_state", state.opt_state)):
            for path, v in flatten_with_path(tree):
                out[tag + keystr(path)] = v.numpy()
        np.savez(os.path.join(d, f"port{rank}.npz"), **out)
        print(json.dumps(dict(rank=rank, rcs=rcs, logs=logs, planted=planted,
                              digest=train.params_digest(state.params),
                              dlrm_calls=dlrm_calls)))
    finally:
        dist.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's one step (4 emulated devices) and the port's 4
    ranks, at once."""
    d = tmp_path_factory.mktemp("mesh_train")
    ref_bundle = ref_get_cell("dimenet", "full_graph_sm", reduced=True)
    batch = {k: np.asarray(v) for k, v in ref_cells.batch_for_cell(ref_bundle, 1).items()}
    np.savez(d / "batch.npz", **_without_self_loops(batch))
    with open(d / "state.pkl", "wb") as f:
        pickle.dump(_to_numpy(ref_bundle.make_state(jax.random.key(0))), f)
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _REFERENCE, str(d)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=ROOT)]
    procs += [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(RANKS), port,
                                str(d)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True, env=env, cwd=ROOT)
              for r in range(RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return dict(d=d, ref=dict(np.load(d / "ref.npz")),
                ranks=[json.loads(o.strip().splitlines()[-1]) for o, _ in outs[1:]],
                port=[dict(np.load(d / f"port{r}.npz")) for r in range(RANKS)])


def test_launcher_trains_on_the_mesh_through_a_failure(runs):
    """Each rank: the failure at step 3 returns 2, the rerun resumes from
    the chain's step 2 and finishes; the writer's log names the resume and
    the bit-equal check; the one chain's newest step is 4."""
    from repro_torch.core import LocalFSStore
    from repro_torch.core import manifest as mf

    for r in runs["ranks"]:
        assert r["rcs"] == [2, 0], r
    first, second = runs["ranks"][0]["logs"]
    assert "injected failure at step 3" in first
    assert "resumed from checkpoint at step 2" in second
    assert "parameters bit-equal after every step and the restore" in second
    assert all(not any(r["logs"]) for r in runs["ranks"][1:])  # only rank 0 prints
    assert mf.latest_step(LocalFSStore(str(runs["d"] / "ckpt"))) == 4


def test_replica_check_fails_on_a_planted_difference(runs):
    for r in runs["ranks"]:
        assert r["planted"].startswith("the ranks' parameters differ planted"), r


def test_one_mesh_step_matches_reference(runs):
    """Loss and accuracy, every new parameter and adagrad accumulator of
    one step on the mesh against the reference's: parameters within 1e-6
    (an adagrad first step moves each by lr = 0.01 times the sign of its
    gradient), accumulators (the squared summed gradients) within 1e-5 of
    each leaf's largest; every rank holds the same bits."""
    ref, port = runs["ref"], runs["port"]
    assert len({r["digest"] for r in runs["ranks"]}) == 1
    np.testing.assert_allclose(port[0]["loss"], ref["loss"], rtol=1e-5)
    assert port[0]["accuracy"] == ref["accuracy"]
    keys = sorted(k for k in ref if k not in ("loss", "accuracy"))
    assert keys == sorted(k for k in port[0] if k not in ("loss", "accuracy"))
    for k in keys:
        for r in range(1, RANKS):
            np.testing.assert_array_equal(port[r][k], port[0][k])
        if k.startswith("params"):
            np.testing.assert_allclose(port[0][k], ref[k], rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(port[0][k], ref[k], rtol=0,
                                       atol=1e-5 * float(np.abs(ref[k]).max()), err_msg=k)


@pytest.mark.parametrize("argv,match", [
    (["--arch", "qwen2-0.5b", "--shape", "train_4k", "--mesh", "2by2"], "DATAxMODEL"),
    (["--arch", "olmoe-1b-7b", "--shape", "train_4k", "--mesh", "0x4"], "at least one rank"),
    (["--arch", "qwen2-0.5b", "--shape", "prefill_32k", "--mesh", "2x2"], "the mesh trains"),
    (["--arch", "minicpm3-4b", "--shape", "train_4k", "--mesh", "2x2", "--pure-fsdp"],
     "pure_fsdp_train")])
def test_mesh_refuses_cells_it_cannot_run(argv, match, monkeypatch):
    """What ``--mesh`` still refuses, each before any group opens (so no
    cell trains on one device in the mesh's place): a mesh spec that does
    not parse or holds no rank on an axis, a serving shape, and a config
    that sets ``pure_fsdp_train`` (``--pure-fsdp`` here stands for such a
    config: the registry holds none)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import _module

    if "--pure-fsdp" in argv:
        argv = [a for a in argv if a != "--pure-fsdp"]
        mod = _module("minicpm3-4b")
        make = mod.make_config
        monkeypatch.setattr(mod, "make_config", lambda reduced=False: dataclasses.replace(
            make(reduced), pure_fsdp_train=True))
    with pytest.raises(ValueError, match=match):
        train.main(argv + ["--device", "cpu"])
    assert not dist.is_initialized()


def test_pure_fsdp_config_has_no_mesh_step():
    """A cell built on a mesh that carries a group from a config with
    ``pure_fsdp_train`` raises rather than train under other rules."""
    import dataclasses

    from repro_torch.configs import _families, _module
    from repro_torch.launch.mesh import make_recording_mesh

    cfg = dataclasses.replace(_module("minicpm3-4b").make_config(), pure_fsdp_train=True)
    mesh = make_recording_mesh(Mesh({"data": 16, "model": 16}))
    with pytest.raises(ValueError, match="pure_fsdp_train"):
        _families.lm_cell("minicpm3-4b", cfg, "train_4k", device="meta", mesh=mesh)


# ------------------------------------------------------------ the dry run


RECSYS_ARCHS = ("xdeepfm", "dlrm-rm2", "mind", "bert4rec")


def _counted(arch, shape):
    return (arch == "dimenet" or arch in EP_ARCHS
            or (arch in RECSYS_ARCHS and shape == "train_batch")
            or (arch_family(arch) == "lm" and shape == "train_4k"))


def _table() -> dict:
    """The dry run's count of every counted cell on both production
    meshes."""
    out = {}
    for name, multi_pod in (("16x16", False), ("2x16x16", True)):
        mesh = make_production_mesh(multi_pod=multi_pod)
        out[name] = {}
        for arch, shape in all_cells():
            coll, note = dryrun.count_collectives(arch, shape, mesh)
            assert note
            if coll is None:
                assert not _counted(arch, shape), (arch, shape)
                assert "A6.6b" not in note and "serving ignores the mesh" in note, note
                continue
            assert _counted(arch, shape), (arch, shape)
            out[name][f"{arch}/{shape}"] = coll
    return out


LM_ARCHS = ("qwen2-0.5b", "nemotron-4-15b", "olmoe-1b-7b", "dbrx-132b", "minicpm3-4b")


def _lm_counts(arch, mesh) -> dict:
    """An LM ``train_4k`` cell's counts on ``mesh`` by the formula of
    ``count_collectives``' docstring, from its layers, micro-batches and
    gates (sequence 4,096 divides every production mesh's ``model``)."""
    from repro_torch.configs import _module

    cfg = _module(arch).make_config()
    D, M = mesh.shape["data"], mesh.shape["model"]
    n_micro, n_c = 4, 4096 // 512
    heads = cfg.n_heads % M == 0
    ag, rs, ar = (2, 1, 0) if cfg.vocab % (D * M) == 0 else (int(D > 1), 0, 0)
    a_ag, a_rs = (3, 3) if heads else (2, 1)
    if cfg.moe:
        f_ag, f_rs, f_ar = 3, 2, 2
    else:
        f_ag, f_rs, f_ar = (3, 2, 0) if cfg.d_ff % M == 0 else (0, 0, 0)
    ag += cfg.n_layers * (a_ag + f_ag)
    rs += cfg.n_layers * (a_rs + f_rs)
    ar += cfg.n_layers * f_ar
    if cfg.vocab % M == 0:
        ag, rs, ar = ag + 1 + 2 * n_c, rs + 1, ar + n_c + int(D > 1)
    else:
        ar += 1
    # the gradients' sums: data (the leaves split over model), the world
    return {"all-gather": n_micro * ag, "reduce-scatter": n_micro * rs,
            "all-reduce": n_micro * ar + 1 + int(D > 1), "all-to-all": 0,
            "collective-permute": 0}


def test_dry_run_collectives_present_where_counted():
    """``collectives`` for dimenet's four cells (three flat graphs and
    ``molecule``), the four recsys train cells, the five LM train cells
    and the eight expert-parallel serving cells on both production meshes,
    null with its reason elsewhere; the LM train cells' counts by the
    formula of ``count_collectives``' docstring; equal to
    ``dryrun_collectives.json``, the table ``chip_smoke.py`` holds the
    card's dry run to (rewrite it with ``python
    tests/test_torch_mesh_train.py``)."""
    table = _table()
    for name in table:
        mesh = make_production_mesh(multi_pod=name == "2x16x16")
        assert len(table[name]) == (4 + len(RECSYS_ARCHS) + len(LM_ARCHS)
                                    + 3 * len(EP_ARCHS)) == 19
        for cell, coll in table[name].items():
            assert set(coll) == set(COLLECTIVE_OPS) | {"total", "wire_total", "wire", "counts"}
            arch = cell.split("/")[0]
            if cell == "dimenet/molecule":
                # the species' all-gather, the loss's sums, the gradients' sum
                assert coll["counts"] == {"all-gather": 1, "reduce-scatter": 0, "all-reduce": 2,
                                          "all-to-all": 0, "collective-permute": 0}, cell
            elif arch == "dimenet":
                assert coll["counts"] == {"all-gather": 3, "reduce-scatter": 3, "all-reduce": 2,
                                          "all-to-all": 0, "collective-permute": 0}, cell
            elif cell.endswith("/train_4k"):
                assert coll["counts"] == _lm_counts(arch, mesh), cell
            elif arch in RECSYS_ARCHS:
                # each exchange: a reduce-scatter over data and an all-reduce
                # over model forward, an all-gather over data backward
                c = coll["counts"]
                assert c["reduce-scatter"] >= 1 and c["all-gather"] >= 2, cell
                assert c["all-reduce"] >= c["reduce-scatter"] + 2, cell
                assert c["all-to-all"] == c["collective-permute"] == 0, cell
            else:
                assert coll["counts"]["all-reduce"] > 0 and coll["total"] == coll["all-reduce"]
    assert json.loads(json.dumps(table)) == json.loads(TABLE.read_text())


def test_dryrun_cli_writes_collectives(tmp_path, capsys):
    assert dryrun.main(["--arch", "dimenet", "--shape", "minibatch_lg",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "dryrun_dimenet_minibatch_lg_pod.json").read_text())
    assert rec["collectives"]["counts"]["all-gather"] == 3
    assert "forward_flat_sharded" in rec["collectives_note"]
    assert "A6.5" not in rec["not_yet"] and "flops" in rec["not_yet"]
    assert "on the wire" in capsys.readouterr().out
    assert dryrun.main(["--arch", "dimenet", "--shape", "molecule",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "dryrun_dimenet_molecule_pod.json").read_text())
    assert rec["collectives"]["counts"]["all-gather"] == 1
    assert "ShardedLookup" in rec["collectives_note"]
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "train_4k",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "dryrun_qwen2-0.5b_train_4k_pod.json").read_text())
    assert rec["collectives"]["counts"] == _lm_counts("qwen2-0.5b", make_production_mesh())
    assert "tensor-parallel" in rec["collectives_note"]
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "prefill_32k",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "dryrun_qwen2-0.5b_prefill_32k_pod.json").read_text())
    assert rec["collectives"] is None and "serving ignores the mesh" in rec["collectives_note"]


def test_dry_run_count_equals_the_calls_over_gloo(runs):
    """The dry run's count for reduced dlrm-rm2 on a 2 × 2 mesh (the
    rank's part on the meta device over recording groups) equals what each
    of the 4 ranks issued running one step over gloo."""
    want, note = dryrun.count_collectives("dlrm-rm2", "train_batch",
                                          Mesh({"data": 2, "model": 2}), reduced=True)
    assert want is not None and "ShardedLookup" in note
    assert (want["counts"]["reduce-scatter"], want["counts"]["all-gather"],
            want["counts"]["all-reduce"]) == (1, 2, 3)
    for r in runs["ranks"]:
        assert r["dlrm_calls"] == json.loads(json.dumps(want))


# ------------------------------------------------------------ the tracker


def test_init_touched_asks_for_the_card():
    from repro_torch.core.tracker import init_touched

    assert init_touched(5, "cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert init_touched(5).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_touched(5)


if __name__ == "__main__":
    TABLE.write_text(json.dumps(_table(), indent=1, sort_keys=True) + "\n")
    print(f"wrote {TABLE}")
