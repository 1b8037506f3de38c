"""The LM train cells on a mesh over a process group: tensor- and
sequence-parallel blocks, the vocabulary-parallel cross-entropy, the
row-sharded ``tok_emb`` and expert-parallel MoE, on 4 gloo processes on the
CPU spawned once for the module.

* One mesh step of each case (the reduced ``train_4k`` cells, sequence 64,
  batch 4, f32 compute in both packages, the reference's initial state
  carried across by ``state_from_numpy`` and its batch) is held to the
  reference's ``jax.jit(bundle.step_fn)`` without a mesh, at the bars of
  the reference's own mesh test (``tests/test_distribution.py``): the loss
  within 1e-4, every accumulator at ``rtol=1e-3, atol=1e-5``, every new
  parameter at the same bars, the touched masks equal. The ranks' state is
  gathered to rank 0 as a save gathers it. The cases: qwen2 on 2 x 2
  (everything divides) and on 1 x 4 (its 4 q heads split, its 2 kv heads
  not), nemotron on 1 x 4 (squared ReLU, no GLU, kv replicated), a
  6-head, 3-kv-head qwen2 on 1 x 4 (attention wholly replicated, ff and
  vocabulary split), minicpm3 on 2 x 2 (MLA), olmoe on 2 x 2 and dbrx on
  1 x 4 (experts split, attention tensor-parallel), olmoe on 4 x 1 (data
  parallel: no ``model`` axis to split the experts over, so the MoE
  dispatches ``dense`` on the rank's tokens), and qwen2 on 1 x 4 at
  sequence 66, which 4 does not divide (no sequence parallelism: the
  residual whole on every rank, each region entered through ``copy_to``
  and left through an all-reduce).

  AdaGrad's first step moves a parameter by −lr·g/(|g| + eps): where the
  gradient is a few eps its slope lr·eps/(|g| + eps)² turns a rounding of
  the gradient into a larger move than the bars take. The port's one
  process step misses the parameter bar against the reference at such
  elements for all five archs (1-2 elements of a leaf, |g| of 1.6e-9 to
  6e-8 against leaf maxima of 1e-2). So each leaf's gradient (the square
  root of its first accumulator) is held at the bar of
  ``test_torch_transformer.py`` (``rtol=1e-3``, ``atol=1e-4`` of the
  leaf's largest), and a parameter element is held at the parameter bars
  unless that gradient bar alone, through the slope, allows it to move
  past 1e-5; at most 2 elements of a leaf, or 1e-3 of a large one, may
  miss so, and each of those must move its parameter the way the
  reference's step moves it (the same sign of p_new − p_init): the
  accumulator holds only |g|, so the sign is held here.
* The MoE cases set ``aux_loss_coef = 0`` (``_moe_ep`` averages the
  shards' aux losses, as the reference's ``shard_map`` cell does, not the
  one-device global one) and ``capacity_factor = E / top_k`` (nothing
  drops), and every rank's router holds the k-th and (k+1)-th routing
  probabilities at least ``MARGIN`` apart.
* Two planted faults in the gradients' groups each fail the comparison:
  the norm gains summed over ``data`` alone, and ``wk``, ``wv``, ``bk``,
  ``bv`` not summed over ``model`` where the kv heads do not split.
* The residual at a block's entry is the rank's (B/DATA, S/MODEL, d).
* The dry run's count for reduced qwen2 and reduced olmoe on 2 x 2 equals
  the calls each rank issued over gloo in one step.
* ``launch.train.main`` trains reduced qwen2 and reduced olmoe on 2 x 2:
  4 steps, saves every 2, a failure at 3, the resume from the one chain;
  the chain restores in the reference to the port's one-process restore
  bit for bit (``tok_emb`` and the expert blocks, with their row state),
  and each rank's range read to the rows it holds.
"""

import dataclasses
import inspect
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
TIMEOUT = 300
MARGIN = 1e-5
LR, EPS = 0.01, 1e-8   # the LM cells' adagrad and row-wise adagrad
# (tag, arch, (data, model), variant)
CASES = [("qwen2-2x2", "qwen2-0.5b", (2, 2), ""),
         ("qwen2-1x4", "qwen2-0.5b", (1, 4), ""),
         ("nemotron-1x4", "nemotron-4-15b", (1, 4), ""),
         ("qwen2h6-1x4", "qwen2-0.5b", (1, 4), "h6"),
         ("minicpm3-2x2", "minicpm3-4b", (2, 2), ""),
         ("olmoe-2x2", "olmoe-1b-7b", (2, 2), ""),
         ("dbrx-1x4", "dbrx-132b", (1, 4), ""),
         ("olmoe-4x1", "olmoe-1b-7b", (4, 1), ""),
         ("qwen2s66-1x4", "qwen2-0.5b", (1, 4), "seq66")]
SEQ66 = 66   # the "seq66" variant's sequence: 4 does not divide it
LAUNCHED = ("qwen2-0.5b", "olmoe-1b-7b")



def held_config(cfg, variant, f32):
    """A case's config, in either package: f32 compute; the 6-head,
    3-kv-head variant; MoE with no aux loss and nothing dropped."""
    cfg = dataclasses.replace(cfg, compute_dtype=f32)
    if variant == "h6":
        cfg = dataclasses.replace(cfg, n_heads=6, n_kv_heads=3)
    if cfg.moe:
        cfg = dataclasses.replace(cfg, aux_loss_coef=0.0, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg


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
        from repro_torch.configs import _families, _module, get_cell
        from repro_torch.configs import shapes as cell_shapes
        from repro_torch.core import CheckNRunManager, CheckpointConfig, LocalFSStore
        from repro_torch.data.cells import batch_for_cell
        from repro_torch.dist.group_ops import recording
        from repro_torch.dist.placement import Placement
        from repro_torch.launch import train
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import layers
        from repro_torch.models import transformer as m_tf
        from repro_torch.train.loop import batch_to_device
        from repro_torch.train.state import state_from_numpy
        from repro_torch.tree import flatten_with_path, keystr

        meshes = {(2, 2): make_host_mesh(2, 2), (1, 4): make_host_mesh(1, 4),
                  (4, 1): make_host_mesh(4, 1)}
        rec = dict(rank=rank, margins={}, digests={})

        margins = []
        router = layers._moe_router

        def routed(xf, w, top_k):
            probs, weights, ids = router(xf, w, top_k)
            top = torch.topk(probs.detach(), top_k + 1, dim=-1).values
            margins.append(float((top[:, top_k - 1] - top[:, top_k]).min()))
            return probs, weights, ids

        layers._moe_router = routed
        shapes = []
        layer = m_tf._layer

        def entered(x, *a, **k):
            shapes.append(tuple(x.shape))
            return layer(x, *a, **k)

        m_tf._layer = entered

        def step_once(case, tag):
            name, arch, dm, variant = case
            mesh = meshes[tuple(dm)]
            cfg = held_config(_module(arch).make_config(True), variant, torch.float32)
            spec = cell_shapes.LM_SHAPES_REDUCED["train_4k"]
            if variant == "seq66":
                cell_shapes.LM_SHAPES_REDUCED["train_4k"] = dict(spec, seq_len=SEQ66)
            try:
                b = _families.lm_cell(arch, cfg, "train_4k", True, "cpu", mesh=mesh)
            finally:
                cell_shapes.LM_SHAPES_REDUCED["train_4k"] = spec
            pl = Placement(b, mesh)
            with open(os.path.join(d, f"{name}.state.pkl"), "rb") as f:
                state = pl.local_state(state_from_numpy(pickle.load(f), "cpu"))
            batch = dict(np.load(os.path.join(d, f"{name}.batch.npz")))
            del margins[:], shapes[:]
            state, metrics = b.step_fn(state, batch_to_device(pl.local_batch(batch), "cpu"))
            rec["margins"][tag] = min(margins) if margins else None
            rec.setdefault("entry", {})[tag] = shapes[0]
            whole = pl.gather_state(state)
            if rank == 0:
                out = {"loss": metrics["loss"].numpy()}
                for t in ("params", "opt_state", "touched"):
                    for path, v in flatten_with_path(getattr(whole, t)):
                        out[t + keystr(path)] = v.numpy()
                np.savez(os.path.join(d, f"{tag}.port.npz"), **out)
            alike = [leaf for path, leaf in flatten_with_path(state.params)
                     if pl.param_is_replicated(path)]
            return train.params_digest(alike)

        # (1) one step of each case
        for case in CASES:
            rec["digests"][case[0]] = step_once(case, case[0])

        # (2) planted faults in the gradients' groups
        axes = _families.lm_grad_axes
        gains = ("['ln1']", "['ln2']", "['final_norm']")
        kv = ("['wk']", "['wv']", "['bk']", "['bv']")
        _families.lm_grad_axes = lambda path, split, tp: (
            ("data",) if any(g in path for g in gains) else axes(path, split, tp))
        step_once(CASES[0], "fault_gains")
        _families.lm_grad_axes = lambda path, split, tp: (
            ("data",) if any(g in path for g in kv) else axes(path, split, tp))
        step_once(CASES[1], "fault_kv")
        _families.lm_grad_axes = axes

        # (3) one step of the registered reduced cells, its calls recorded
        rec["calls"] = {}
        for arch in LAUNCHED:
            b = get_cell(arch, "train_4k", reduced=True, device="cpu", mesh=meshes[(2, 2)])
            pl = Placement(b, meshes[(2, 2)])
            with recording() as r:
                b.step_fn(pl.init_state(), batch_to_device(
                    pl.local_batch(batch_for_cell(b, 0)), "cpu"))
            rec["calls"][arch] = r.summary()

        # (4) the launcher: fail at 3, resume; each rank's range read
        layers._moe_router, m_tf._layer = router, layer
        rec["launcher"] = {}
        for arch in LAUNCHED:
            ckpt = os.path.join(d, f"ckpt-{arch}")
            cmd = ["--arch", arch, "--shape", "train_4k", "--steps", "4", "--interval", "2",
                   "--bits", "4", "--device", "cpu", "--mesh", "2x2", "--ckpt-dir", ckpt]
            rcs, logs = [], []
            for extra in (["--fail-at", "3"], []):
                buf = io.StringIO()
                with redirect_stdout(buf):
                    rcs.append(train.main(cmd + extra))
                logs.append(buf.getvalue())
            b = get_cell(arch, "train_4k", reduced=True, device="cpu", mesh=meshes[(2, 2)])
            pl = Placement(b, meshes[(2, 2)])
            ranges = {n: pl.row_ranges(n) for n in b.tracked}
            mgr = CheckNRunManager(LocalFSStore(ckpt),
                                   CheckpointConfig(async_write=False, device="cpu"))
            part = mgr.restore_part(rank, num_hosts=world, ranges=ranges)
            mgr.close()
            np.savez(os.path.join(d, f"part-{arch}-{rank}.npz"),
                     **{k: v for k, v in part.tables.items()},
                     **{f"{k}/{a}": v for k, s in part.row_state.items() for a, v in s.items()})
            rec["launcher"][arch] = dict(rcs=rcs, logs=logs, ranges=ranges,
                                         read=part.extra["shard"]["row_ranges"])
        print(json.dumps(rec))
    finally:
        dist.destroy_process_group()
""")

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ref_bundle(arch, variant):
    cfg = held_config(ref_module(arch).make_config(True), variant, jnp.float32)
    return ref_families.lm_cell(arch, cfg, "train_4k", None, True)


def _ref_step(name, arch, variant, d):
    """The reference's one step without a mesh, flattened as the ranks
    write theirs."""
    bundle = _ref_bundle(arch, variant)
    state = bundle.make_state(jax.random.key(0))
    batch = dict(np.load(d / f"{name}.batch.npz"))
    init = {"init" + jax.tree_util.keystr(path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(state.params)}
    state, metrics = jax.jit(bundle.step_fn)(state, batch)
    out = {"loss": np.asarray(metrics["loss"]), **init}
    for tag, tree in (("params", state.params), ("opt_state", state.opt_state),
                      ("touched", state.touched)):
        for path, v in jax.tree_util.tree_leaves_with_path(tree):
            out[tag + jax.tree_util.keystr(path)] = np.asarray(v)
    return out


def _grad(acc, shape):
    """A leaf's gradient magnitude after AdaGrad's first step, from its
    accumulator (the squares' sum, or a row's mean square), at every
    element of the leaf."""
    g = np.sqrt(acc.astype(np.float64))
    return np.broadcast_to(g.reshape(g.shape + (1,) * (len(shape) - g.ndim)), shape)


def _mismatches(port, ref):
    """The keys where ``port`` misses ``ref`` at the bars (the module's
    docstring), and the share of each leaf's elements held through their
    gradient. ``ref`` holds the initial parameters too (``init...``)."""
    init = {k[len("init"):]: v for k, v in ref.items() if k.startswith("init")}
    ref = {k: v for k, v in ref.items() if not k.startswith("init")}
    assert sorted(port) == sorted(ref), (sorted(port), sorted(ref))
    bad, through = [], {}
    for k in ref:
        if k == "loss":
            ok = abs(float(port[k]) - float(ref[k])) < 1e-4
        elif k.startswith("touched"):
            ok = np.array_equal(port[k], ref[k])
        elif k.startswith("opt_state"):
            g_p, g_r = np.sqrt(port[k].astype(np.float64)), np.sqrt(ref[k].astype(np.float64))
            ok = (np.allclose(port[k], ref[k], rtol=1e-3, atol=1e-5)
                  and np.allclose(g_p, g_r, rtol=1e-3, atol=1e-4 * float(g_r.max())))
        else:
            g = _grad(ref["opt_state" + k[len("params"):]], ref[k].shape)
            ill = LR * EPS * 1e-4 * float(g.max()) / (g + EPS) ** 2 > 1e-5
            held = np.isclose(port[k], ref[k], rtol=1e-3, atol=1e-5)
            p0 = init[k[len("params"):]]
            same_way = np.sign(port[k] - p0) == np.sign(ref[k] - p0)
            through[k] = int((~held).sum())
            ok = (bool(np.all(held | (ill & same_way)))
                  and through[k] <= max(2, 1e-3 * held.size))
        if not ok:
            bad.append(k)
    return bad, through


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4 ranks, and the reference's one-device steps while they run."""
    d = tmp_path_factory.mktemp("mesh_lm")
    for name, arch, _, variant in CASES:
        bundle = _ref_bundle(arch, variant)
        with open(d / f"{name}.state.pkl", "wb") as f:
            pickle.dump(_to_numpy(bundle.make_state(jax.random.key(0))), f)
        batch = {k: np.asarray(v) for k, v in ref_cells.batch_for_cell(bundle, 1).items()}
        if variant == "seq66":
            tokens = np.random.default_rng(66).integers(0, 512, (4, SEQ66 + 1), np.int32)
            batch = dict(tokens=tokens[:, :-1], labels=tokens[:, 1:])
        np.savez(d / f"{name}.batch.npz", **batch)
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    port = str(_free_port())
    code = (f"import dataclasses\nCASES = {CASES!r}\nLAUNCHED = {LAUNCHED!r}\n"
            f"SEQ66 = {SEQ66}\n"
            + inspect.getsource(held_config) + _WORKER)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(RANKS), port, str(d)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=ROOT)
             for r in range(RANKS)]
    try:
        ref = {name: _ref_step(name, arch, variant, d) for name, arch, _, variant in CASES}
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return dict(d=d, ref=ref, ranks=[json.loads(o.strip().splitlines()[-1]) for o, _ in outs])


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_one_mesh_step_matches_reference(runs, name):
    """The ranks' step, gathered, against the reference's one-device step;
    the replicated parameters bit-equal on every rank; the MoE cases'
    routing margins above ``MARGIN`` on every rank."""
    port = dict(np.load(runs["d"] / f"{name}.port.npz"))
    bad, through = _mismatches(port, runs["ref"][name])
    assert bad == [], (bad, {k: v for k, v in through.items() if v})
    assert len({r["digests"][name] for r in runs["ranks"]}) == 1
    if "olmoe" in name or "dbrx" in name:
        for r in runs["ranks"]:
            assert r["margins"][name] > MARGIN, (r["rank"], r["margins"][name])


@pytest.mark.parametrize("tag,case,leaves", [
    ("fault_gains", "qwen2-2x2", ("['ln1']", "['ln2']", "['final_norm']")),
    ("fault_kv", "qwen2-1x4", ("['wk']", "['wv']", "['bk']", "['bv']"))])
def test_planted_gradient_group_faults_fail(runs, tag, case, leaves):
    """A gradient summed over too few ranks passes every forward check
    (the loss is the same) and misses only in the update: here the
    accumulators of the leaves the fault touches."""
    port = dict(np.load(runs["d"] / f"{tag}.port.npz"))
    ref = runs["ref"][case]
    assert abs(float(port["loss"]) - float(ref["loss"])) < 1e-4
    bad, _ = _mismatches(port, ref)
    assert bad and all(any(leaf in k for leaf in leaves) for k in bad), bad
    assert any(k.startswith("opt_state") for k in bad), bad


@pytest.mark.parametrize("name,want", [("qwen2-2x2", (2, 32, 64)), ("qwen2-1x4", (4, 16, 64)),
                                       ("minicpm3-2x2", (2, 32, 64)),
                                       ("qwen2s66-1x4", (4, SEQ66, 64))])
def test_residual_is_the_sequence_slice(runs, name, want):
    """(B/DATA, S/MODEL, d) at a block's entry on every rank; the whole
    sequence where MODEL does not divide it."""
    for r in runs["ranks"]:
        assert tuple(r["entry"][name]) == want, r["entry"]


@pytest.mark.parametrize("arch", LAUNCHED)
def test_dry_run_count_equals_the_calls_over_gloo(runs, arch):
    """The dry run's count for the reduced cell on a 2 x 2 mesh (the rank's
    part on the meta device over recording groups) equals what each of the
    4 ranks issued in one step over gloo."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh

    want, note = dryrun.count_collectives(arch, "train_4k", Mesh({"data": 2, "model": 2}),
                                          reduced=True)
    assert want is not None and "tensor-parallel" in note
    for r in runs["ranks"]:
        assert r["calls"][arch] == json.loads(json.dumps(want))


@pytest.mark.parametrize("arch", LAUNCHED)
def test_launcher_trains_on_the_mesh_through_a_failure(runs, arch):
    """Each rank: the failure at 3 returns 2, the rerun resumes from step
    2 and finishes; rank 0's log names the resume, the restored rows'
    check and the gathers; only rank 0 prints."""
    for r in runs["ranks"]:
        assert r["launcher"][arch]["rcs"] == [2, 0], r["launcher"][arch]
    first, second = runs["ranks"][0]["launcher"][arch]["logs"]
    assert "injected failure at step 3" in first
    assert "resumed from checkpoint at step 2" in second
    assert "restored rows of 4 ranks bit-equal to the one-process restore of step 2" in second
    assert "parameters bit-equal after every step and the restore" in second
    assert "to rank 0 a save" in second
    assert all(not any(r["launcher"][arch]["logs"]) for r in runs["ranks"][1:])


@pytest.mark.parametrize("arch", LAUNCHED)
def test_chain_restores_in_reference_and_by_rank(runs, arch):
    """The chain's last step restored by the reference package equals the
    port's one-process restore bit for bit (``tok_emb`` and, for olmoe,
    the expert blocks, with their row state); each rank's range read (an
    expert block one range a layer) equals its rows of that restore."""
    from repro_torch.core import CheckNRunManager, CheckpointConfig, LocalFSStore

    path = str(runs["d"] / f"ckpt-{arch}")
    ref_mgr = RefManager(RefStore(path), RefConfig(async_write=False))
    port_mgr = CheckNRunManager(LocalFSStore(path), CheckpointConfig(async_write=False,
                                                                     device="cpu"))
    try:
        a, b = ref_mgr.restore(), port_mgr.restore()
    finally:
        ref_mgr.close()
        port_mgr.close()
    want = {"tok_emb"} | ({"moe_w_up", "moe_w_gate", "moe_w_down"} if "olmoe" in arch else set())
    assert a.step == b.step == 4 and set(a.tables) == set(b.tables) == want
    for name in a.tables:
        np.testing.assert_array_equal(a.tables[name], b.tables[name], err_msg=name)
        assert sorted(a.row_state[name]) == sorted(b.row_state[name])
        for k in a.row_state[name]:
            np.testing.assert_array_equal(a.row_state[name][k], b.row_state[name][k],
                                          err_msg=f"{name}/{k}")
    for rank, r in enumerate(runs["ranks"]):
        la = r["launcher"][arch]
        part = dict(np.load(runs["d"] / f"part-{arch}-{rank}.npz"))
        for name, ranges in la["ranges"].items():
            assert la["read"][name] == ranges
            if name.startswith("moe"):
                assert len(ranges) == 2   # one range a layer: experts of model index j
            rows = np.concatenate([b.tables[name][lo:hi] for lo, hi in ranges])
            np.testing.assert_array_equal(part[name], rows, err_msg=name)
            for k, v in b.row_state[name].items():
                np.testing.assert_array_equal(
                    part[f"{name}/{k}"], np.concatenate([v[lo:hi] for lo, hi in ranges]),
                    err_msg=f"{name}/{k}")
