"""The port's serving slice against the reference, on the CPU.

* ``models.dlrm.serve`` against ``repro.models.dlrm.serve`` on reduced
  dlrm-rm2 ``serve_p99`` and ``serve_bulk``: params from the reference's
  init (carried over with ``state_from_numpy``), the same numpy batch. In
  f32 compute the probabilities agree within 1e-5 (sums in another
  order); in the model's bf16 within 1e-3, which allows for bf16 rounding
  at other places in the two frameworks: it is about twice the gap
  between the reference's own bf16 and f32 forwards on these inputs
  (at most 6e-4).
* A chain written by the reference's Trainer restores into the port's
  serve bundle and scores as the reference's restored model does (f32,
  1e-5).
* ``CheckpointSubscriber``: the port's, on an ``InMemoryStore``, serves
  exactly what a cold ``restore(step)`` gives at every step, across a
  forced full-checkpoint boundary (the reference's
  ``test_differential_every_step_incl_full_boundary``); on one store, the
  port's subscriber, the reference's subscriber and both packages'
  ``restore()`` give bit-identical tables.
* The serve launcher on the CPU answers from a chain that the port's train
  launcher wrote.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_cell as ref_get_cell
from repro.core import CheckNRunManager as RefManager
from repro.core import CheckpointConfig as RefConfig
from repro.core import LocalFSStore as RefLocalFSStore
from repro.core import PAPER_DEFAULTS as REF_DEFAULTS
from repro.data.cells import batch_for_cell as ref_batch_for_cell
from repro.models import dlrm as ref_dlrm
from repro.serve import CheckpointSubscriber as RefSubscriber
from repro.train.loop import Trainer as RefTrainer
from repro.train.loop import TrainerConfig as RefTrainerConfig
from repro.train.state import restore_train_state as ref_restore_train_state
from repro_torch.configs import get_cell
from repro_torch.core import (CheckNRunManager, CheckpointConfig, InMemoryStore,
                              LocalFSStore, PAPER_DEFAULTS, Snapshot)
from repro_torch.core import manifest as mf
from repro_torch.data.cells import batch_for_cell
from repro_torch.kernels.dot_interaction import dot_interaction_torch
from repro_torch.kernels.embedding_bag import embedding_bag_fields_torch
from repro_torch.models import dlrm
from repro_torch.serve import CheckpointSubscriber, EmbeddingServer
from repro_torch.train.loop import batch_to_device
from repro_torch.train.state import restore_train_state, state_from_numpy

SERVE_SHAPES = ["serve_p99", "serve_bulk"]


def _to_numpy(ref_state):
    tree = lambda t: jax.tree.map(lambda a: np.array(a), t)
    return dict(step=np.asarray(ref_state.step), params=tree(ref_state.params),
                opt_state=tree(ref_state.opt_state), touched=tree(ref_state.touched),
                rng=np.asarray(jax.random.key_data(ref_state.rng)))


def _f32(ref_bundle, bundle):
    return (dataclasses.replace(ref_bundle.cfg, compute_dtype=jnp.float32),
            dataclasses.replace(bundle.cfg, compute_dtype=torch.float32))


@pytest.fixture(scope="module")
def cells():
    out = {}
    for shape in SERVE_SHAPES:
        ref_bundle = ref_get_cell("dlrm-rm2", shape, reduced=True)
        bundle = get_cell("dlrm-rm2", shape, reduced=True, device="cpu")
        out[shape] = (ref_bundle, bundle)
    ref_state = out["serve_p99"][0].make_state()
    return out, ref_state, _to_numpy(ref_state)


@pytest.mark.parametrize("shape", SERVE_SHAPES)
def test_serve_cell_shapes_and_batches(cells, shape):
    ref_bundle, bundle = cells[0][shape]
    assert bundle.kind == "serve" and list(bundle.make_inputs()) == ["sparse_ids", "dense"]
    want_b = {"serve_p99": 16, "serve_bulk": 128}[shape]
    assert bundle.make_inputs()["sparse_ids"].shape == (want_b, 26, 1)
    a, b = ref_batch_for_cell(ref_bundle, 7), batch_for_cell(bundle, 7)
    assert sorted(a) == sorted(b) == ["dense", "sparse_ids"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SERVE_SHAPES)
def test_serve_matches_reference(cells, shape, compute):
    (ref_bundle, bundle), ref_state, np_state = cells[0][shape], cells[1], cells[2]
    ref_cfg, cfg = ((ref_bundle.cfg, bundle.cfg) if compute == "bf16"
                    else _f32(ref_bundle, bundle))
    state = state_from_numpy(np_state, "cpu")
    batch = ref_batch_for_cell(ref_bundle, 3)
    want = np.asarray(ref_dlrm.serve(ref_state.params, batch, ref_cfg))
    got = dlrm.serve(state.params, batch_to_device(batch, "cpu"), cfg)
    assert got.dtype == torch.float32 and not got.requires_grad
    assert got.shape == (batch["dense"].shape[0],)
    bar = 1e-5 if compute == "f32" else 1e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=bar)
    if compute == "bf16":
        # the bundle's step_fn is the same forward
        np.testing.assert_array_equal(
            bundle.step_fn(state.params, batch_to_device(batch, "cpu")).numpy(),
            got.numpy())


def test_plain_ops_give_the_same_forward(cells):
    """``serve`` with the plain ops passed in (as the card check does) is
    the default forward on CPU tensors, bit for bit."""
    (_, bundle), _, np_state = cells[0]["serve_p99"], cells[1], cells[2]
    state = state_from_numpy(np_state, "cpu")
    batch = batch_to_device(batch_for_cell(bundle, 1), "cpu")
    a = dlrm.serve(state.params, batch, bundle.cfg)
    b = dlrm.serve(state.params, batch, bundle.cfg, bag=embedding_bag_fields_torch,
                   interact=dot_interaction_torch)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_retrieval_cell_names_its_roadmap_entry():
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        get_cell("dlrm-rm2", "retrieval_cand", reduced=True, device="cpu")


def test_reference_chain_restores_into_the_port_serve_bundle(cells, tmp_path):
    ref_train = ref_get_cell("dlrm-rm2", "train_batch", reduced=True)
    tr = RefTrainer(ref_train, RefLocalFSStore(str(tmp_path)),
                    RefConfig(interval_batches=2, policy="intermittent",
                              quant=REF_DEFAULTS[4], async_write=False),
                    RefTrainerConfig(total_steps=4))
    tr.init_or_restore()
    tr.run(4)
    tr.close()

    ref_bundle, bundle = cells[0]["serve_p99"]
    ref_cfg, cfg = _f32(ref_bundle, bundle)
    ref_mgr = RefManager(RefLocalFSStore(str(tmp_path)), RefConfig(async_write=False))
    rs_ref = ref_mgr.restore()
    ref_mgr.close()
    ref_params = ref_restore_train_state(ref_bundle.make_state(), rs_ref,
                                         ref_bundle.tracked).params
    mgr = CheckNRunManager(LocalFSStore(str(tmp_path)), CheckpointConfig(device="cpu"))
    rs = mgr.restore()
    mgr.close()
    assert rs.step == rs_ref.step == 4 and rs.chain_len == 2
    params = restore_train_state(bundle.make_state(), rs, bundle.tracked).params
    for name, t in params["tables"].items():
        np.testing.assert_array_equal(t.numpy(), rs_ref.tables[name], err_msg=name)
    batch = ref_batch_for_cell(ref_bundle, 11)
    want = np.asarray(ref_dlrm.serve(ref_params, batch, ref_cfg))
    got = dlrm.serve(params, batch_to_device(batch, "cpu"), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# ------------------------------------------------------------- subscriber


class TrainingJob:
    """Training-job stand-in (the reference test's): owns the arrays,
    mutates a random row subset per step, saves through the port's
    manager. ``force_full_next`` resets the policy's baseline, the only way
    ``consecutive`` writes a full checkpoint again."""

    def __init__(self, store, quant=None, rows=160, dim=4, seed=0):
        self.rng = np.random.default_rng(seed)
        self.tabs = {
            "emb0": self.rng.normal(size=(rows, dim)).astype(np.float32),
            "emb1": self.rng.normal(size=(rows + 37, dim)).astype(np.float32),
        }
        self.step_no = 0
        self.mgr = CheckNRunManager(store, CheckpointConfig(
            policy="consecutive", quant=quant, async_write=False,
            chunk_rows=64, keep_latest=20, device="cpu"))

    def step(self, frac=0.08):
        self.step_no += 1
        touched = {}
        for name, arr in self.tabs.items():
            n = max(1, int(arr.shape[0] * frac))
            idx = self.rng.choice(arr.shape[0], size=n, replace=False)
            arr[idx] += self.rng.normal(size=(n, arr.shape[1])).astype(np.float32)
            t = np.zeros(arr.shape[0], bool)
            t[idx] = True
            touched[name] = t
        dense = {"mlp/w": self.rng.normal(size=(6, 6)).astype(np.float32)}
        self.mgr.save(Snapshot(
            step=self.step_no, tables={k: v.copy() for k, v in self.tabs.items()},
            row_state={n: {} for n in self.tabs}, touched=touched, dense=dense,
            extra={}), block=True)
        return self.step_no

    def force_full_next(self):
        self.mgr.policy.state.baseline_step = None

    def close(self):
        self.mgr.close()


def _cold_restore(store, step):
    mgr = CheckNRunManager(store, CheckpointConfig(async_write=False, device="cpu"))
    try:
        return mgr.restore(step)
    finally:
        mgr.close()


def _assert_serves_exactly(sub, want, step):
    with sub.server.pinned() as v:
        assert v.step == step
        for name, arr in want.tables.items():
            np.testing.assert_array_equal(v.lookup(name, np.arange(arr.shape[0])),
                                          arr, err_msg=name)
        for name, arr in want.dense.items():
            np.testing.assert_array_equal(v.dense(name), arr, err_msg=name)


def test_differential_every_step_incl_full_boundary():
    store = InMemoryStore()
    drv = TrainingJob(store)
    sub = CheckpointSubscriber(store, EmbeddingServer())
    try:
        for i in range(8):
            if i == 4:
                drv.force_full_next()  # full-checkpoint boundary mid-run
            step = drv.step()
            assert sub.poll_once() is True
            _assert_serves_exactly(sub, _cold_restore(store, step), step)
    finally:
        drv.close()
    assert mf.load(store, 5).kind == "full"
    assert mf.load(store, 6).kind == "incremental"
    m = sub.metrics()
    assert m["state"] == "live" and m["lag_steps"] == 0
    # steps 2-4 and 6-8 ride the delta path; 1 and the boundary resync
    assert m["incremental_refreshes_total"] == 6
    assert m["full_syncs_total"] == 2


def test_port_and_reference_subscribers_and_restores_agree(tmp_path):
    drv = TrainingJob(LocalFSStore(str(tmp_path)), quant=PAPER_DEFAULTS[4], rows=300)
    port_sub = CheckpointSubscriber(LocalFSStore(str(tmp_path)))
    ref_sub = RefSubscriber(RefLocalFSStore(str(tmp_path)))
    try:
        for _ in range(3):
            step = drv.step()
            assert port_sub.poll_once() and ref_sub.poll_once()
            want = _cold_restore(LocalFSStore(str(tmp_path)), step)
            ref_mgr = RefManager(RefLocalFSStore(str(tmp_path)),
                                 RefConfig(async_write=False))
            ref_rs = ref_mgr.restore(step)
            ref_mgr.close()
            _assert_serves_exactly(port_sub, want, step)
            _assert_serves_exactly(ref_sub, want, step)
            for name, arr in want.tables.items():
                np.testing.assert_array_equal(ref_rs.tables[name], arr, err_msg=name)
    finally:
        drv.close()
    assert port_sub.metrics()["incremental_refreshes_total"] == 2
    assert port_sub.refresh_bytes_total == ref_sub.refresh_bytes_total


# ------------------------------------------------------------- launcher


def test_serve_launcher_answers_from_the_train_launchers_chain(tmp_path, capsys):
    from repro_torch.launch import serve, train

    assert train.main(["--arch", "dlrm-rm2", "--shape", "train_batch",
                       "--steps", "4", "--interval", "2", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path)]) == 0
    capsys.readouterr()
    assert serve.main(["--ckpt-dir", str(tmp_path), "--device", "cpu",
                       "--requests", "48", "--batch", "16"]) == 0
    out = capsys.readouterr().out
    assert "serving dlrm-rm2 from checkpoint step 4" in out
    assert "served 48 requests in 3 batches on cpu" in out and "p99" in out


def test_serve_launcher_without_a_chain(tmp_path, capsys):
    from repro_torch.launch import serve

    assert serve.main(["--ckpt-dir", str(tmp_path), "--device", "cpu"]) == 1
    assert "no checkpoints" in capsys.readouterr().out
