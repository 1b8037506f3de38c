"""The port's BERT4Rec slice against the reference, on reduced bert4rec
(2,048 items, dim 16, seq 16, 2 blocks of 2 heads).

Both sides compute in float32 and start from the same numbers: the
reference's initial TrainState is carried into the port through
``state_from_numpy``, and both draw the same numpy batches. Model outputs
(``encode``, ``serve``) are held at rtol/atol 1e-5 and the loss at 1e-5:
the same f32 arithmetic, with sums (matmuls, layernorm means, softmax
denominators) taken in another order. The train step is held at the bars
of ``tests/test_torch_dlrm.py``: loss within 1e-4, params at rtol 1e-3 /
atol 1e-5. Checkpoints: a chain written by either package's Trainer
restores in the other to the tables, aux and dense arrays the writer's own
restore gives, and the same snapshot saved at 4-bit uniform_asym by both
packages gives byte-identical chunk objects (the store contract).
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
from repro.core import InMemoryStore as RefStore
from repro.core import LocalFSStore as RefLocalFSStore
from repro.core.quantize import QuantConfig as RefQuant
from repro.data.cells import batch_for_cell as ref_batch_for_cell
from repro.models import bert4rec as ref_b4r
from repro.train.loop import Trainer as RefTrainer
from repro.train.loop import TrainerConfig as RefTrainerConfig
from repro.train.state import state_to_snapshot as ref_state_to_snapshot
from repro.train.steps import make_train_step as ref_make_train_step
from repro_torch.configs import get_cell
from repro_torch.core import CheckNRunManager, CheckpointConfig, InMemoryStore, LocalFSStore
from repro_torch.core.quantize import QuantConfig
from repro_torch.data.cells import batch_for_cell
from repro_torch.models import bert4rec
from repro_torch.train.loop import Trainer, TrainerConfig, batch_to_device
from repro_torch.train.state import state_from_numpy, state_to_snapshot
from repro_torch.train.steps import make_train_step
from repro_torch.tree import flatten_with_path, keystr

U4 = dict(bits=4, method="uniform_asym")


@pytest.fixture(scope="module")
def cells():
    ref_bundle = ref_get_cell("bert4rec", "train_batch", reduced=True)
    bundle = get_cell("bert4rec", "train_batch", reduced=True, device="cpu")
    ref_cfg = dataclasses.replace(ref_bundle.cfg, compute_dtype=jnp.float32)
    cfg = dataclasses.replace(bundle.cfg, compute_dtype=torch.float32)
    ref_state = ref_bundle.make_state()
    return ref_bundle, bundle, ref_cfg, cfg, ref_state, _to_numpy(ref_state)


def _to_numpy(ref_state):
    tree = lambda t: jax.tree.map(lambda a: np.array(a), t)
    return dict(step=np.asarray(ref_state.step), params=tree(ref_state.params),
                opt_state=tree(ref_state.opt_state), touched=tree(ref_state.touched),
                rng=np.asarray(jax.random.key_data(ref_state.rng)))


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("shape", ["train_batch", "serve_p99", "serve_bulk"])
def test_batches_identical(shape):
    ref_bundle = ref_get_cell("bert4rec", shape, reduced=True)
    bundle = get_cell("bert4rec", shape, reduced=True, device="cpu")
    for i in (0, 3):
        a, b = ref_batch_for_cell(ref_bundle, i), batch_for_cell(bundle, i)
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k


def test_params_tree_and_snapshot_keys_match(cells):
    ref_bundle, bundle, _, _, ref_state, np_state = cells
    state = bundle.make_state()
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_state.params)[0]
    leaves = flatten_with_path(state.params)
    assert [jax.tree_util.keystr(k) for k, _ in ref_leaves] == [keystr(k) for k, _ in leaves]
    for (_, a), (_, b) in zip(ref_leaves, leaves):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.float32
    a = ref_state_to_snapshot(ref_state, ref_bundle.tracked, {})
    b = state_to_snapshot(state_from_numpy(np_state, "cpu"), bundle.tracked, {})
    assert list(a.dense) == list(b.dense)
    assert "params['blocks']['wq']" in b.dense and "opt['dense']['out_bias']" in b.dense
    for k in a.dense:
        assert a.dense[k].tobytes() == b.dense[k].tobytes(), k
    assert list(a.tables) == list(b.tables) == ["item_0"]


def test_encode_and_serve_match_reference(cells):
    ref_bundle, bundle, ref_cfg, cfg, ref_state, np_state = cells
    state = state_from_numpy(np_state, "cpu")
    items = ref_batch_for_cell(ref_bundle, 1)["items"]
    want = np.asarray(ref_b4r.encode(ref_state.params, jnp.asarray(items), ref_cfg))
    got = _np(bert4rec.encode(state.params, torch.from_numpy(items), cfg))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for shape in ("serve_p99", "serve_bulk"):   # bulk runs in two slices
        sb = get_cell("bert4rec", shape, reduced=True, device="cpu")
        batch = batch_for_cell(sb, 2)
        want = np.asarray(ref_b4r.serve(ref_state.params, batch, ref_cfg))
        got = _np(bert4rec.serve(state.params, batch_to_device(batch, "cpu"), cfg))
        assert got.shape == (batch["items"].shape[0], 100)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_serve_slices_give_the_unsliced_scores(cells):
    _, bundle, _, cfg, _, np_state = cells
    params = state_from_numpy(np_state, "cpu").params
    sb = get_cell("bert4rec", "serve_bulk", reduced=True, device="cpu")
    batch = batch_to_device(batch_for_cell(sb, 0), "cpu")
    sliced = bert4rec.serve(params, batch, dataclasses.replace(cfg, serve_slice_rows=48))
    whole = bert4rec.serve(params, batch, dataclasses.replace(cfg, serve_slice_rows=None))
    torch.testing.assert_close(sliced, whole, rtol=1e-6, atol=1e-6)


def test_train_loss_matches_reference(cells):
    ref_bundle, _, ref_cfg, cfg, ref_state, np_state = cells
    state = state_from_numpy(np_state, "cpu")
    batch = ref_batch_for_cell(ref_bundle, 5)
    ref_loss, ref_aux = ref_b4r.train_loss(ref_state.params, batch, ref_cfg)
    loss, aux = bert4rec.train_loss(state.params, batch_to_device(batch, "cpu"), cfg)
    assert abs(float(ref_loss) - float(loss)) < 1e-5
    assert abs(float(ref_aux["accuracy"]) - float(aux["accuracy"])) < 1e-6
    np.testing.assert_array_equal(_np(aux["touched"]["item_0"]),
                                  np.asarray(ref_aux["touched"]["item_0"]))


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_steps_match_reference(cells, n_micro):
    ref_bundle, bundle, ref_cfg, cfg, ref_state, np_state = cells
    ref_step = jax.jit(ref_make_train_step(
        lambda p, b: ref_b4r.train_loss(p, b, ref_cfg), ref_bundle.optimizer,
        n_micro=n_micro))
    step = make_train_step(lambda p, b: bert4rec.train_loss(p, b, cfg),
                           bundle.optimizer, n_micro=n_micro)
    state = state_from_numpy(np_state, "cpu")
    for i in range(2):  # the second step starts from non-zero accumulators
        batch = ref_batch_for_cell(ref_bundle, i)
        ref_state, ref_m = ref_step(ref_state, batch)
        state, m = step(state, batch_to_device(batch, "cpu"))
        assert abs(float(ref_m["loss"]) - float(m["loss"])) < 1e-4
        assert abs(float(ref_m["accuracy"]) - float(m["accuracy"])) < 1e-6
        assert state.step == int(ref_state.step) == i + 1
        for tree in ("params", "opt_state"):
            ref_leaves = jax.tree_util.tree_flatten_with_path(getattr(ref_state, tree))[0]
            leaves = flatten_with_path(getattr(state, tree))
            assert len(ref_leaves) == len(leaves)
            for (ka, a), (kb, b) in zip(ref_leaves, leaves):
                assert jax.tree_util.keystr(ka) == keystr(kb)
                np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-3, atol=1e-5,
                                           err_msg=keystr(kb))
        np.testing.assert_array_equal(_np(state.touched["item_0"]),
                                      np.asarray(ref_state.touched["item_0"]))


def test_uniform_4bit_chunks_byte_identical(cells):
    """One trained state, snapshotted by each package and saved at 4-bit
    uniform_asym (a full save, then an incremental one): the chunk objects
    and dense blobs are the same bytes."""
    ref_bundle, bundle, ref_cfg, _, ref_state, _ = cells
    ref_step = jax.jit(ref_make_train_step(
        lambda p, b: ref_b4r.train_loss(p, b, ref_cfg), ref_bundle.optimizer))
    kw = dict(policy="one_shot", async_write=False, chunk_rows=512)
    ref_store, port_store = RefStore(), InMemoryStore()
    ref_mgr = RefManager(ref_store, RefConfig(quant=RefQuant(**U4), **kw))
    mgr = CheckNRunManager(port_store, CheckpointConfig(quant=QuantConfig(**U4),
                                                        device="cpu", **kw))
    st = ref_state
    for i in range(2):
        st, _ = ref_step(st, ref_batch_for_cell(ref_bundle, i))
        ref_mgr.save(ref_state_to_snapshot(st, ref_bundle.tracked, {})).result()
        mgr.save(state_to_snapshot(state_from_numpy(_to_numpy(st), "cpu"),
                                   bundle.tracked, {})).result()
        st = dataclasses.replace(st, touched=jax.tree.map(jnp.zeros_like, st.touched))
    ref_mgr.close()
    mgr.close()
    keys = sorted(ref_store.list(""))
    assert keys == sorted(port_store.list("")) and any("chunks/" in k for k in keys)
    for k in keys:
        if "chunks/" in k:
            assert ref_store.get(k) == port_store.get(k), k


def _assert_same_restore(a, b):
    assert a.step == b.step and sorted(a.tables) == sorted(b.tables) == ["item_0"]
    for n in a.tables:
        np.testing.assert_array_equal(a.tables[n], b.tables[n])
        assert sorted(a.row_state[n]) == sorted(b.row_state[n]) == ["opt_acc"]
        np.testing.assert_array_equal(a.row_state[n]["opt_acc"], b.row_state[n]["opt_acc"])
    assert sorted(a.dense) == sorted(b.dense)
    for k in a.dense:
        np.testing.assert_array_equal(a.dense[k], b.dense[k], err_msg=k)


def _restores(path):
    ref = RefManager(RefLocalFSStore(path), RefConfig(async_write=False))
    port = CheckNRunManager(LocalFSStore(path), CheckpointConfig(async_write=False,
                                                                 device="cpu"))
    try:
        return ref.restore(), port.restore()
    finally:
        ref.close()
        port.close()


def test_port_chain_restores_in_the_reference(tmp_path):
    bundle = get_cell("bert4rec", "train_batch", reduced=True, device="cpu")
    cfg = CheckpointConfig(interval_batches=2, policy="intermittent",
                           quant=QuantConfig(**U4), device="cpu")
    tr = Trainer(bundle, LocalFSStore(str(tmp_path)), cfg,
                 TrainerConfig(total_steps=4, log_every=1))
    assert tr.init_or_restore() == 0
    tr.run(4)
    tr.close()
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    ref_rs, port_rs = _restores(str(tmp_path))
    assert port_rs.step == 4 and port_rs.chain_len == 2   # a full save and a delta
    _assert_same_restore(ref_rs, port_rs)
    # the port's Trainer resumes from its chain into the bert4rec tree
    tr2 = Trainer(bundle, LocalFSStore(str(tmp_path)), cfg, TrainerConfig(total_steps=6))
    assert tr2.init_or_restore() == 4
    np.testing.assert_array_equal(_np(tr2.state.params["tables"]["item_0"]),
                                  port_rs.tables["item_0"])
    np.testing.assert_array_equal(_np(tr2.state.params["dense"]["blocks"]["wq"]),
                                  port_rs.dense["params['blocks']['wq']"])
    tr2.close()


def test_reference_chain_restores_in_the_port(tmp_path):
    ref_bundle = ref_get_cell("bert4rec", "train_batch", reduced=True)
    cfg = RefConfig(interval_batches=2, policy="intermittent", quant=RefQuant(**U4))
    tr = RefTrainer(ref_bundle, RefLocalFSStore(str(tmp_path)), cfg,
                    RefTrainerConfig(total_steps=4))
    tr.init_or_restore()
    tr.run(4)
    tr.close()
    ref_rs, port_rs = _restores(str(tmp_path))
    assert ref_rs.step == 4 and ref_rs.chain_len == 2
    _assert_same_restore(ref_rs, port_rs)
    bundle = get_cell("bert4rec", "train_batch", reduced=True, device="cpu")
    tr2 = Trainer(bundle, LocalFSStore(str(tmp_path)),
                  CheckpointConfig(interval_batches=2, quant=QuantConfig(**U4),
                                   device="cpu"), TrainerConfig(total_steps=6))
    assert tr2.init_or_restore() == 4
    np.testing.assert_array_equal(_np(tr2.state.opt_state["tables"]["item_0"]),
                                  ref_rs.row_state["item_0"]["opt_acc"])
    np.testing.assert_array_equal(_np(tr2.state.params["dense"]["out_bias"]),
                                  ref_rs.dense["params['out_bias']"])
    tr2.run(2)
    tr2.close()


def test_launchers_train_and_serve_bert4rec_on_cpu(tmp_path, capsys):
    from repro_torch.launch import serve, train

    assert train.main(["--arch", "bert4rec", "--shape", "train_batch", "--steps", "4",
                       "--interval", "2", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path)]) == 0
    assert "checkpoint bytes written" in capsys.readouterr().out
    assert serve.main(["--arch", "bert4rec", "--ckpt-dir", str(tmp_path),
                       "--requests", "48", "--batch", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "from checkpoint step 4" in out and "host scores out" in out


def test_bert4rec_takes_no_vocab_cap():
    with pytest.raises(ValueError, match="no vocab cap"):
        get_cell("bert4rec", "serve_p99", reduced=True, device="cpu", vocab_cap=512)
