"""The port's sharded DimeNet (``forward_flat_sharded``, ``train_loss`` on a
mesh) across 8 CPU processes against the reference's under ``shard_map`` on
8 emulated devices, both on a 2 × 4 ``("data", "model")`` mesh (the mesh and
config of ``tests/test_distribution.py::test_sharded_dimenet_equals_plain``:
2 blocks, hidden 16, 2 bilinear, 3 × 2 bases, 24 features, 5 classes).

The reference runs in a subprocess that sets ``XLA_FLAGS`` before it
imports JAX; the port's ranks are 8 ``python -c`` processes on a gloo group
at ``tcp://127.0.0.1:<free port>``, each with a timeout, each destroying
its group; the pytest process opens no group. Both take the same numpy
inputs and the reference's parameters (``init_params(key(0))``, and the
reduced ``minibatch_lg`` cell's ``make_state(key(0))``) through numpy.

Data:
  * ``local``: the reference test's graph (64 nodes, 128 edges, a triplet
    of edge e takes an edge of e's own range of 16), so no triplet crosses
    a range; ``local_noloops`` is it with each self-loop's target moved to
    the next node (the reference's gradient is NaN at a self-loop, ROADMAP
    C), for the loss and gradients;
  * ``crossing``: 256 triplets over random edges, so the locality clamp
    (``kj % E_l``, ``ji % E_l``) moves most of them: the port must copy it;
  * ``cell``: the reduced ``minibatch_lg`` cell's batch from
    ``batch_for_cell`` (272 nodes, 256 edges, 512 triplets, 16 seeds, all
    in rank 0's node range), ``cell_noloops`` without its self-loops. The
    reference's loss under the mesh stops on such a ``seed_idx`` batch (a
    sharding error in its take of the sharded logits), so its loss and
    gradients are held to the reference's ``train_loss`` without a mesh on
    the batch with the clamp applied (``cell_clamped``);
  * ``graph_noloops``: the reduced ``full_graph_sm`` cell's batch (128
    nodes, every node a seed) without its self-loops, for the loss and
    gradients under the mesh.

Held: each rank's rows against the reference's rows of its range, within
1e-5 of the row's scale (its largest entry) in f32 compute and within
that test's 3e-2 of it in bf16 (read: at most 8.5e-7 in f32; in bf16
0.012 / 0.017 / 0.030 on the cell, local and crossing data, where the two
packages' bf16 GEMMs round differently); on the local data the rows also against the port's
``forward_flat``, and on the crossing data against ``forward_flat`` of the
batch with the clamp applied (``clamp_remap``: the check the card runs at
full size); loss and accuracy against the reference's ``train_loss`` under
the mesh; the ranks' gradients, summed by ``train.steps.sum_grads``,
against ``jax.grad`` of it under the mesh, within 1e-5 of each leaf's
largest entry (read: at most 1.3e-6); the collectives the ranks record (``dist.group_ops``)
against the reference's compiled HLO read by its ``collective_bytes``; the
dry run's count (meta device, recording mesh) against the calls the ranks
made over gloo, for the reduced ``minibatch_lg`` step, olmoe's
tensor-parallel train step and its prefill's expert-parallel layers; and ``_use_sharded`` against the reference's
on every gnn cell.
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
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_cell as ref_get_cell
from repro.data import cells as ref_cells
from repro.dist.sharding import gnn_rules as ref_gnn_rules
from repro.models import dimenet as ref_dn
from repro_torch.configs import FAMILY_SHAPES, FAMILY_SHAPES_REDUCED, get_cell
from repro_torch.dist.sharding import gnn_rules
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models import dimenet as dn
from repro_torch.tree import tree_map
from test_torch_dimenet import _without_self_loops
from test_torch_mind import _to_numpy

DATA, MODEL = 2, 4
RANKS = DATA * MODEL
CFG = dict(name="t", n_blocks=2, d_hidden=16, n_bilinear=2, n_spherical=3, n_radial=2,
           d_feat=24, n_out=5)
ROWS = ("local", "crossing", "cell")
MESH_LOSSES = ("local_noloops", "crossing", "graph_noloops")
LOSSES = MESH_LOSSES + ("cell_noloops",)
# which parameters (and config) a case takes
PARAMS_OF = dict(local="test", local_noloops="test", crossing="test", cell="cell",
                 cell_noloops="cell", cell_clamped="cell", graph_noloops="graph")
FIELDS = ("features", "edge_src", "edge_dst", "tri_kj", "tri_ji", "labels", "seed_idx")
ROOT = str(pathlib.Path(__file__).resolve().parents[1])
TIMEOUT = 240
F32_ROW_BAR = 1e-5    # of a row's scale (its largest |entry|)
BF16_BAR = 3e-2       # the reference test's bf16 bar, of a row's scale

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json, pickle
    import jax, jax.numpy as jnp, numpy as np
    jax.devices()
    from repro.configs import get_cell
    from repro.dist.sharding import gnn_rules
    from repro.launch.dryrun import collective_bytes
    from repro.models import dimenet as m_dn

    d = sys.argv[1]
    inp = np.load(os.path.join(d, "in.npz"))
    with open(os.path.join(d, "params.pkl"), "rb") as f:
        params = pickle.load(f)
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    rules = gnn_rules(mesh)
    cfgs = dict(test=m_dn.DimeNetConfig(**__CFG__),
                cell=get_cell("dimenet", "minibatch_lg", reduced=True).cfg,
                graph=get_cell("dimenet", "full_graph_sm", reduced=True).cfg)
    out, hlo = {}, {}

    def case(name):
        batch = {k.split("/")[1]: jnp.asarray(inp[k]) for k in inp.files
                 if k.startswith(name + "/")}
        return __PARAMS_OF__[name], batch

    def value_and_grad(name, which, batch, dt, rules):
        cfg = dataclasses.replace(cfgs[which], compute_dtype=getattr(jnp, dt))
        vg = jax.value_and_grad(lambda p, b: m_dn.train_loss(p, b, cfg, rules), has_aux=True)
        c = jax.jit(vg).lower(params[which], batch).compile()
        (loss, aux), g = c(params[which], batch)
        if dt == "float32":
            out[f"loss/{name}"] = np.asarray(loss)
            out[f"accuracy/{name}"] = np.asarray(aux["accuracy"])
            for path, v in jax.tree_util.tree_leaves_with_path(g):
                out[f"grad/{name}/" + jax.tree_util.keystr(path)] = np.asarray(v)
        return c, cfg

    def keep(c, key):
        hlo[key] = {k: v for k, v in collective_bytes(c.as_text(), 8).items()}

    with mesh:
        for name in __ROWS__:
            which, batch = case(name)
            for dt in ("float32", "bfloat16"):
                cfg = dataclasses.replace(cfgs[which], compute_dtype=getattr(jnp, dt))
                fwd = lambda p, b: m_dn.forward_flat_sharded(p, b, cfg, rules)
                c = jax.jit(fwd).lower(params[which], batch).compile()
                out[f"rows/{name}/{dt}"] = np.asarray(c(params[which], batch))
                if name == "local":
                    keep(c, f"forward/{dt}")
        for name in __MESH_LOSSES__:
            which, batch = case(name)
            for dt in ("float32", "bfloat16") if name == "local_noloops" else ("float32",):
                c, cfg = value_and_grad(name, which, batch, dt, rules)
                if name == "local_noloops":
                    keep(c, f"value_and_grad/{dt}")
                    grad = jax.grad(lambda p, b: m_dn.train_loss(p, b, cfg, rules)[0])
                    keep(jax.jit(grad).lower(params[which], batch).compile(), f"grad/{dt}")
    # a seed_idx batch stops under the mesh (a sharding error in its take of
    # the sharded logits): the cell is held to the plain loss of the batch
    # with the clamp applied
    which, batch = case("cell_clamped")
    value_and_grad("cell_noloops", which, batch, "float32", m_dn.NO_SHARDING)
    np.savez(os.path.join(d, "ref.npz"), **out)
    with open(os.path.join(d, "ref_hlo.json"), "w") as f:
        json.dump(hlo, f)
    print("OK")
""")
for _k, _v in dict(CFG=CFG, ROWS=ROWS, MESH_LOSSES=MESH_LOSSES, PARAMS_OF=PARAMS_OF).items():
    _REFERENCE = _REFERENCE.replace(f"__{_k}__", repr(_v))

_WORKER = textwrap.dedent("""
    import dataclasses, datetime, json, os, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, port, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from repro_torch.configs import get_cell
        from repro_torch.dist.group_ops import recording
        from repro_torch.dist.sharding import gnn_rules
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import dimenet as dn
        from repro_torch.train.loop import batch_to_device
        from repro_torch.train.steps import sum_grads
        from repro_torch.tree import flatten_with_path, keystr, tree_map

        mesh = make_host_mesh(__DATA__, __MODEL__)
        assert mesh.coords == dict(data=rank // __MODEL__, model=rank % __MODEL__)
        rules = gnn_rules(mesh)
        group = mesh.group_for(("data", "model"))
        inp = np.load(os.path.join(d, "in.npz"))
        with open(os.path.join(d, "params.pkl"), "rb") as f:
            params_np = pickle.load(f)
        cell = get_cell("dimenet", "minibatch_lg", reduced=True, device="cpu", mesh=mesh)
        cfgs = dict(test=dn.DimeNetConfig(**__CFG__), cell=cell.cfg,
                    graph=get_cell("dimenet", "full_graph_sm", reduced=True, device="cpu").cfg)
        out, rec = {}, {}

        def case(name):
            batch = {k.split("/")[1]: torch.from_numpy(inp[k]) for k in inp.files
                     if k.startswith(name + "/")}
            return __PARAMS_OF__[name], batch

        for name in __ROWS__:
            which, batch = case(name)
            params = tree_map(torch.from_numpy, params_np[which])
            for dt in ("float32", "bfloat16"):
                cfg = dataclasses.replace(cfgs[which], compute_dtype=getattr(torch, dt))
                assert dn._use_sharded(batch, cfg, rules)
                with recording() as r:
                    rows = dn.forward_flat_sharded(params, batch, cfg, rules)
                out[f"rows/{name}/{dt}"] = rows.numpy()
                if name == "local":
                    rec[f"forward/{dt}"] = r.summary()
        for name in __LOSSES__:
            which, batch = case(name)
            for dt in ("float32", "bfloat16") if name == "local_noloops" else ("float32",):
                cfg = dataclasses.replace(cfgs[which], compute_dtype=getattr(torch, dt))
                params = tree_map(lambda a: torch.tensor(a, requires_grad=True),
                                  params_np[which])
                leaves = [p for _, p in flatten_with_path(params)]
                with recording() as r:
                    loss, aux = dn.train_loss(params, batch, cfg, rules)
                    grads = sum_grads(list(torch.autograd.grad(loss, leaves)), group)
                rec[f"grad/{name}/{dt}"] = r.summary()
                if dt == "float32":
                    out[f"loss/{name}"] = loss.detach().numpy()
                    out[f"accuracy/{name}"] = aux["accuracy"].numpy()
                    for (path, _), g in zip(flatten_with_path(params), grads):
                        out[f"grad/{name}/" + keystr(path)] = g.numpy()
        # the cell's train step, olmoe's tensor-parallel train step (the
        # rank's blocks and data shard) and its prefill's expert-parallel
        # layers, as the dry run counts them, here over gloo
        from repro_torch.data.cells import batch_for_cell
        from repro_torch.dist.placement import Placement

        batch = batch_to_device({k.split("/")[1]: inp[k] for k in inp.files
                                 if k.startswith("cell/")}, "cpu")
        rec["dryrun/dimenet"] = dryrun.step_collectives(cell, cell.make_state(0), batch)
        lm = get_cell("olmoe-1b-7b", "train_4k", reduced=True, device="cpu", mesh=mesh)
        pl = Placement(lm, mesh)
        rec["dryrun/olmoe"] = dryrun.step_collectives(
            lm, pl.init_state(), batch_to_device(pl.local_batch(batch_for_cell(lm, 0)), "cpu"))
        prefill = get_cell("olmoe-1b-7b", "prefill_32k", reduced=True, device="cpu", mesh=mesh)
        rec["dryrun/olmoe_prefill"] = dryrun.moe_collectives(prefill, mesh, device="cpu")
        np.savez(os.path.join(d, f"port{rank}.npz"), **out)
        with open(os.path.join(d, f"port{rank}.json"), "w") as f:
            json.dump(rec, f)
        finite = all(bool(np.isfinite(v).all()) for v in out.values())
        print(json.dumps(dict(rank=rank, ok=True, finite=finite)))
    finally:
        dist.destroy_process_group()
""")
for _k, _v in dict(DATA=DATA, MODEL=MODEL, CFG=CFG, ROWS=ROWS, LOSSES=LOSSES,
                   PARAMS_OF=PARAMS_OF).items():
    _WORKER = _WORKER.replace(f"__{_k}__", repr(_v))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _local():
    """The reference test's graph, drawn in its order, then labels."""
    rng = np.random.default_rng(0)
    N, E = 64, 128
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    ji = np.arange(E, dtype=np.int32)
    kj = (ji // 16) * 16 + rng.integers(0, 16, E).astype(np.int32)
    feats = rng.normal(size=(N, 24)).astype(np.float32)
    labels = rng.integers(0, 5, N).astype(np.int32)
    return dict(features=feats, edge_src=src, edge_dst=dst, tri_kj=kj, tri_ji=ji,
                labels=labels)


def _crossing():
    """64 nodes, 128 edges without self-loops, 256 triplets whose edges
    are drawn over the whole graph."""
    rng = np.random.default_rng(1)
    N, E, T = 64, 128, 256
    src = rng.integers(0, N, E)
    dst = (src + rng.integers(1, N, E)) % N
    return dict(features=rng.normal(size=(N, 24)).astype(np.float32),
                edge_src=src.astype(np.int32), edge_dst=dst.astype(np.int32),
                tri_kj=rng.integers(0, E, T).astype(np.int32),
                tri_ji=rng.integers(0, E, T).astype(np.int32),
                labels=rng.integers(0, 5, N).astype(np.int32))


def _cases():
    local = _local()
    noloops = dict(local)
    loop = local["edge_src"] == local["edge_dst"]
    assert loop.any()
    noloops["edge_dst"] = np.where(loop, (local["edge_dst"] + 1) % 64,
                                   local["edge_dst"]).astype(np.int32)
    cell = ref_cells.batch_for_cell(ref_get_cell("dimenet", "minibatch_lg", reduced=True), 1)
    cell = {k: np.asarray(v) for k, v in cell.items()}
    cell_noloops = _without_self_loops(cell)
    kj, ji = dn.clamp_remap({k: torch.from_numpy(v) for k, v in cell_noloops.items()}, RANKS)
    graph = ref_cells.batch_for_cell(ref_get_cell("dimenet", "full_graph_sm", reduced=True), 1)
    return dict(local=local, local_noloops=noloops, crossing=_crossing(), cell=cell,
                cell_noloops=cell_noloops,
                cell_clamped=dict(cell_noloops, tri_kj=kj.numpy().astype(np.int32),
                                  tri_ji=ji.numpy().astype(np.int32)),
                graph_noloops=_without_self_loops({k: np.asarray(v) for k, v in graph.items()}))


def _params():
    cfg = ref_dn.DimeNetConfig(**CFG)
    test = jax.tree.map(np.asarray, ref_dn.init_params(jax.random.key(0), cfg))
    cell, graph = (_to_numpy(ref_get_cell("dimenet", shape, reduced=True).make_state(
        jax.random.key(0)))["params"] for shape in ("minibatch_lg", "full_graph_sm"))
    return dict(test=test, cell=cell, graph=graph)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides run once for the file's tests: the reference's
    subprocess and the port's 8 ranks at once."""
    d = tmp_path_factory.mktemp("dimenet_sharded")
    cases = _cases()
    np.savez(d / "in.npz", **{f"{c}/{k}": v for c, b in cases.items() for k, v in b.items()
                              if k in FIELDS})
    with open(d / "params.pkl", "wb") as f:
        pickle.dump(_params(), f)
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
    ranks = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs[1:]]
    return dict(cases=cases, ref=dict(np.load(d / "ref.npz")),
                hlo=json.loads((d / "ref_hlo.json").read_text()), ranks=ranks,
                port=[dict(np.load(d / f"port{r}.npz")) for r in range(RANKS)],
                rec=[json.loads((d / f"port{r}.json").read_text()) for r in range(RANKS)])


def _row_errors(got, want):
    """Each row's largest difference over the row's scale (largest |entry|)."""
    return np.abs(got - want).max(axis=1) / np.maximum(np.abs(want).max(axis=1), 1e-30)


def _within(got, want, dtype, what=""):
    """Each row within ``F32_ROW_BAR`` (f32) or ``BF16_BAR`` (bf16) of its
    scale."""
    assert got.shape == want.shape
    err = _row_errors(got, want).max()
    assert err <= (F32_ROW_BAR if dtype == "float32" else BF16_BAR), (what, float(err))


def _ranks_rows(runs, key):
    return np.concatenate([runs["port"][r][key] for r in range(RANKS)])


def _port_cfg(case, dtype):
    which = PARAMS_OF[case]
    cfg = (dn.DimeNetConfig(**CFG) if which == "test" else get_cell(
        "dimenet", "minibatch_lg" if which == "cell" else "full_graph_sm", reduced=True,
        device="cpu").cfg)
    return dataclasses.replace(cfg, compute_dtype=getattr(torch, dtype))


def _port_params(case):
    return tree_map(torch.from_numpy, _params()[PARAMS_OF[case]])


def test_ranks_finish_finite(runs):
    assert [r["rank"] for r in runs["ranks"]] == list(range(RANKS))
    assert all(r["ok"] and r["finite"] for r in runs["ranks"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ROWS)
def test_rows_match_reference_shard_map(runs, case, dtype):
    """Rank r's rows are the reference's rows of node range r, on data
    where the clamp moves triplets too."""
    key = f"rows/{case}/{dtype}"
    want = runs["ref"][key]
    got = _ranks_rows(runs, key)
    assert got.shape == want.shape and got.dtype == np.float32
    assert runs["port"][0][key].shape[0] == want.shape[0] // RANKS
    _within(got, want, dtype, key)


def _moved(batch, n):
    kj, ji = dn.clamp_remap({k: torch.from_numpy(v) for k, v in batch.items()}, n)
    return float(((kj.numpy() != batch["tri_kj"]) | (ji.numpy() != batch["tri_ji"])).mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_local_rows_match_port_forward_flat(runs, dtype):
    """Where no triplet crosses a range the clamp moves nothing, and the
    ranks' rows are the plain forward's."""
    batch = runs["cases"]["local"]
    assert _moved(batch, RANKS) == 0.0
    want = dn.forward_flat(_port_params("local"),
                           {k: torch.from_numpy(v) for k, v in batch.items()},
                           _port_cfg("local", dtype)).numpy()
    _within(_ranks_rows(runs, f"rows/local/{dtype}"), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["crossing", "cell"])
def test_rows_are_forward_flat_of_the_clamped_batch(runs, case, dtype):
    """The one-process check the card runs at full size: the ranks' rows
    equal ``forward_flat`` on the batch with the clamp applied
    (``clamp_remap``), up to the order of the node sums; and the clamp
    moves triplets on this data, so the plain batch gives other rows."""
    batch = {k: torch.from_numpy(v) for k, v in runs["cases"][case].items()}
    assert _moved(runs["cases"][case], RANKS) > 0.3
    kj, ji = dn.clamp_remap(batch, RANKS)
    params, cfg = _port_params(case), _port_cfg(case, dtype)
    want = dn.forward_flat(params, dict(batch, tri_kj=kj, tri_ji=ji), cfg).numpy()
    got = _ranks_rows(runs, f"rows/{case}/{dtype}")
    _within(got, want, dtype)
    if dtype == "float32":
        plain = dn.forward_flat(params, batch, cfg).numpy()
        assert _row_errors(got, plain).max() > 100 * F32_ROW_BAR


@pytest.mark.parametrize("case", LOSSES)
def test_loss_and_accuracy_match_reference(runs, case):
    for r in range(RANKS):
        np.testing.assert_allclose(runs["port"][r][f"loss/{case}"], runs["ref"][f"loss/{case}"],
                                   rtol=1e-5)
        assert runs["port"][r][f"accuracy/{case}"] == runs["ref"][f"accuracy/{case}"]
        assert runs["port"][r][f"loss/{case}"] == runs["port"][0][f"loss/{case}"]


@pytest.mark.parametrize("case", LOSSES)
def test_summed_gradients_match_reference(runs, case):
    """The rule ``train_loss`` states: a parameter's gradient is the sum of
    the ranks' gradients (``sum_grads``, one all-reduce), which every rank
    then holds bit-equal."""
    keys = sorted(k for k in runs["ref"] if k.startswith(f"grad/{case}/"))
    assert keys and keys == sorted(k for k in runs["port"][0] if k.startswith(f"grad/{case}/"))
    for k in keys:
        want = runs["ref"][k]
        assert np.isfinite(want).all(), k
        for r in range(RANKS):
            np.testing.assert_array_equal(runs["port"][r][k], runs["port"][0][k])
        np.testing.assert_allclose(runs["port"][0][k], want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=k)


def _ops(summary):
    return {op: (summary["counts"][op], summary[op])
            for op in ("all-gather", "reduce-scatter", "all-reduce")}


def test_forward_collectives_match_reference_hlo(runs):
    """In f32 the ranks' forward issues what the reference's compiled HLO
    holds, op for op and byte for byte: the (N, h) and (N, 3) all-gathers
    (512 + 96 B a device) and the (N, h) f32 reduce-scatter (4,096 B). In
    bf16 the port gathers the embeddings in bf16, 256 B; XLA on the CPU
    moves them in f32, as in f32 compute."""
    for r in range(RANKS):
        got, want = runs["rec"][r]["forward/float32"], runs["hlo"]["forward/float32"]
        assert _ops(got) == _ops(want) == {"all-gather": (2, 608.0),
                                           "reduce-scatter": (1, 4096.0),
                                           "all-reduce": (0, 0.0)}
        assert got["wire_total"] == want["wire_total"]
        bf = runs["rec"][r]["forward/bfloat16"]
        assert _ops(runs["hlo"]["forward/bfloat16"]) == _ops(want)
        assert _ops(bf) == {"all-gather": (2, 608.0 - 256), "reduce-scatter": (1, 4096.0),
                            "all-reduce": (0, 0.0)}


def test_gradient_step_collectives_match_reference_hlo(runs):
    """The gradient step (``train_loss`` forward and backward, then
    ``sum_grads``) in f32 against the reference's HLO: the all-gathers
    (the forward's two and the reduce-scatter's transpose, 1,120 B) and
    reduce-scatters (the forward's and the two gathers' transposes, 8,960
    B) op for op; the all-reduces byte for byte against ``value_and_grad``
    (19,164 B: the 4,789 f32 gradients and the loss's (sum, hits), 8 B)
    but in two ops where XLA merges them into one. ``jax.grad`` alone
    (no loss value) holds the gradients' 19,156 B. In bf16 the embeddings'
    gather and its transpose move bf16 (256 and 2,048 B less than XLA's
    f32)."""
    n_params = 4789
    for r in range(RANKS):
        got = runs["rec"][r]["grad/local_noloops/float32"]
        vg, grad = runs["hlo"]["value_and_grad/float32"], runs["hlo"]["grad/float32"]
        assert _ops(vg)["all-gather"] == _ops(got)["all-gather"] == (3, 1120.0)
        assert _ops(vg)["reduce-scatter"] == _ops(got)["reduce-scatter"] == (3, 8960.0)
        assert _ops(grad) == dict(_ops(vg), **{"all-reduce": (1, 4.0 * n_params)})
        assert _ops(vg)["all-reduce"] == (1, 4.0 * n_params + 8)
        assert _ops(got)["all-reduce"] == (2, 4.0 * n_params + 8)
        bf = runs["rec"][r]["grad/local_noloops/bfloat16"]
        assert _ops(runs["hlo"]["value_and_grad/bfloat16"]) == _ops(vg)
        assert _ops(bf) == {"all-gather": (3, 1120.0 - 256), "reduce-scatter": (3, 8960.0 - 2048),
                            "all-reduce": (2, 4.0 * n_params + 8)}


def _mesh_2x4():
    return Mesh({"data": DATA, "model": MODEL})


@pytest.mark.parametrize("arch,shape,key", [("dimenet", "minibatch_lg", "dryrun/dimenet"),
                                            ("olmoe-1b-7b", "train_4k", "dryrun/olmoe"),
                                            ("olmoe-1b-7b", "prefill_32k",
                                             "dryrun/olmoe_prefill")])
def test_dry_run_count_equals_the_calls_over_gloo(runs, arch, shape, key):
    """The dry run's count (the cell's code on the meta device over a
    recording mesh) equals what the 8 ranks issued running the same code
    over gloo: the reduced ``minibatch_lg`` train step, and olmoe's
    tensor-parallel train step (its 2 layers: heads, experts, vocabulary,
    sequence and ``tok_emb``'s rows all split on 2 x 4; the formula of
    ``count_collectives``' docstring), and its prefill's expert-parallel
    layers (``moe_collectives``, forward: the combine, the touched masks
    and the aux losses a layer)."""
    want, note = dryrun.count_collectives(arch, shape, _mesh_2x4(), reduced=True)
    assert want is not None and note
    for r in range(RANKS):
        assert runs["rec"][r][key] == want
    counts = want["counts"]
    if arch == "dimenet":
        assert (counts["all-gather"], counts["reduce-scatter"], counts["all-reduce"]) == (3, 3, 2)
        return
    layers = get_cell(arch, shape, reduced=True, device="meta").cfg.n_layers
    if shape == "prefill_32k":
        assert (counts["all-gather"], counts["reduce-scatter"], counts["all-reduce"]) == (
            0, 0, 3 * layers)
    else:
        # tok_emb 2 + 1, a layer 6 + 5 + 2, one cross-entropy chunk 3 + 1 + 2,
        # the gradients' 2 sums
        assert (counts["all-gather"], counts["reduce-scatter"], counts["all-reduce"]) == (
            2 + 6 * layers + 3, 1 + 5 * layers + 1, 2 * layers + 2 + 2)


def _ref_mesh(shape):
    return None if shape is None else AbstractMesh(tuple(shape.values()), tuple(shape))


@pytest.mark.parametrize("reduced", [True, False])
def test_use_sharded_agrees_with_reference(reduced):
    """On every gnn cell, with no mesh, the production meshes and the
    test meshes."""
    shapes = [None, {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
              {"data": 2, "model": 4}, {"data": 2, "model": 2}, {"data": 4, "model": 8}]
    seen = set()
    for shape in (FAMILY_SHAPES_REDUCED if reduced else FAMILY_SHAPES)["gnn"]:
        ref_bundle = ref_get_cell("dimenet", shape, reduced=reduced)
        bundle = get_cell("dimenet", shape, reduced=reduced, device="meta")
        for mesh in shapes:
            ref = ref_dn._use_sharded(ref_bundle.make_inputs(), ref_bundle.cfg,
                                      ref_gnn_rules(_ref_mesh(mesh)))
            got = dn._use_sharded(bundle.make_inputs(), bundle.cfg,
                                  gnn_rules(None if mesh is None else Mesh(mesh)))
            assert got == ref, (shape, mesh)
            seen.add(got)
    assert seen == {True, False}


def test_sharded_forward_raises_without_a_group():
    """No quiet way round: the sharded forward needs a mesh with a group."""
    batch = {k: torch.from_numpy(v) for k, v in _local().items()}
    cfg = dn.DimeNetConfig(**CFG)
    params = _port_params("local")
    rules = gnn_rules(_mesh_2x4())
    assert dn._use_sharded(batch, cfg, rules)
    with pytest.raises(ValueError, match="group"):
        dn.forward_flat_sharded(params, batch, cfg, rules)
    with pytest.raises(ValueError, match="group"):
        dn.train_loss(params, batch, cfg, rules)
    # serving ignores the mesh, as the reference's does
    torch.testing.assert_close(dn.serve(params, batch, cfg, rules),
                               dn.serve(params, batch, cfg), rtol=0, atol=0)
