"""The port's MIND slice (``repro_torch.models.mind``) against the
reference, on reduced MIND (2,048 items, dim 16, 4 interests, 3 routing
iterations, history 10).

Both sides start from the same numbers: the reference's initial TrainState
is carried into the port through ``state_from_numpy``, and both draw the
same numpy batches. Forwards (``interests``, ``serve``,
``serve_retrieval``, ``train_loss``) are held at rtol/atol 1e-5 in f32,
where the port keeps the reference's op order and dtypes; at the
published bf16 compute at 1e-4, the tightest bar that held over 5 seeds
(the bf16 bilinear product's sums round in another order: 1.9e-5 at
worst). One train step is held at ``tests/test_torch_dlrm.py``'s bars: loss
within 1e-4, params at rtol 1e-3 / atol 1e-5. Checkpoints: the same
snapshot saved by both packages gives byte-identical chunk objects at
``quant=None`` and 4-bit uniform_asym, and at 4-bit adaptive scale and zero
allclose with at most 2e-3 of codes differing; each package restores the
other's store to the same tables, aux and dense arrays (``routing_init``
among them).

The helpers here (``_cells``, ``_snapshot_pair``, ``_check_chunks``,
``_check_cross_restore``, ``_check_cell_smoke``) serve
``tests/test_torch_xdeepfm.py`` too.
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
from repro.core.quantize import QuantConfig as RefQuant
from repro.data.cells import batch_for_cell as ref_batch_for_cell
from repro.models import mind as ref_mind
from repro.train.state import state_to_snapshot as ref_state_to_snapshot
from repro.train.steps import make_train_step as ref_make_train_step
from repro_torch.configs import get_cell
from repro_torch.core import CheckNRunManager, CheckpointConfig, InMemoryStore
from repro_torch.core import manifest as mf
from repro_torch.core import packing
from repro_torch.core.quantize import QuantConfig
from repro_torch.data.cells import batch_for_cell
from repro_torch.models import mind
from repro_torch.train.loop import batch_to_device
from repro_torch.train.state import state_from_numpy, state_to_snapshot
from repro_torch.train.steps import make_train_step
from repro_torch.tree import flatten_with_path, keystr

SHAPES = ["train_batch", "serve_p99", "serve_bulk", "retrieval_cand"]
QUANTS = {"none": None, "u4": dict(bits=4, method="uniform_asym"),
          "a4": dict(bits=4, method="adaptive")}


def _to_numpy(ref_state):
    tree = lambda t: jax.tree.map(lambda a: np.array(a), t)
    return dict(step=np.asarray(ref_state.step), params=tree(ref_state.params),
                opt_state=tree(ref_state.opt_state), touched=tree(ref_state.touched),
                rng=np.asarray(jax.random.key_data(ref_state.rng)))


def _np(t):
    return t.detach().cpu().numpy()


def _cells(arch, seed=0):
    """(reference bundle, port bundle, reference state, its numpy copy) of
    the reduced train cell."""
    ref_bundle = ref_get_cell(arch, "train_batch", reduced=True)
    bundle = get_cell(arch, "train_batch", reduced=True, device="cpu")
    ref_state = ref_bundle.make_state(jax.random.key(seed))
    return ref_bundle, bundle, ref_state, _to_numpy(ref_state)


def _cfgs(ref_bundle, bundle, dtype):
    return (dataclasses.replace(ref_bundle.cfg, compute_dtype=getattr(jnp, dtype)),
            dataclasses.replace(bundle.cfg, compute_dtype=getattr(torch, dtype)))


def _check_batches(arch, shape):
    ref_bundle = ref_get_cell(arch, shape, reduced=True)
    bundle = get_cell(arch, shape, reduced=True, device="cpu")
    for i in (0, 3):
        a, b = ref_batch_for_cell(ref_bundle, i), batch_for_cell(bundle, i)
        assert list(a) == list(b) == list(bundle.make_inputs())
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k


def _check_tree_and_snapshot(ref_bundle, bundle, ref_state, np_state):
    state = bundle.make_state()
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_state.params)[0]
    leaves = flatten_with_path(state.params)
    assert [jax.tree_util.keystr(k) for k, _ in ref_leaves] == [keystr(k) for k, _ in leaves]
    for (_, a), (_, b) in zip(ref_leaves, leaves):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.float32
    a = ref_state_to_snapshot(ref_state, ref_bundle.tracked, {})
    b = state_to_snapshot(state_from_numpy(np_state, "cpu"), bundle.tracked, {})
    assert list(a.dense) == list(b.dense)
    for k in a.dense:
        assert a.dense[k].tobytes() == b.dense[k].tobytes(), k
        assert a.dense[k].shape == b.dense[k].shape, k
    assert list(a.tables) == list(b.tables)
    return b


def _check_train_steps(ref_bundle, bundle, ref_state, np_state, ref_loss, loss):
    """Two steps of each package's generic step, in f32, from one state."""
    ref_cfg, cfg = _cfgs(ref_bundle, bundle, "float32")
    ref_step = jax.jit(ref_make_train_step(lambda p, b: ref_loss(p, b, ref_cfg),
                                           ref_bundle.optimizer))
    step = make_train_step(lambda p, b: loss(p, b, cfg), bundle.optimizer)
    state = state_from_numpy(np_state, "cpu")
    for i in range(2):  # the second step starts from non-zero accumulators
        batch = ref_batch_for_cell(ref_bundle, i)
        ref_state, ref_m = ref_step(ref_state, batch)
        state, m = step(state, batch_to_device(batch, "cpu"))
        assert abs(float(ref_m["loss"]) - float(m["loss"])) < 1e-4
        assert abs(float(ref_m["accuracy"]) - float(m["accuracy"])) < 1e-6
        for tree in ("params", "opt_state"):
            ref_leaves = jax.tree_util.tree_flatten_with_path(getattr(ref_state, tree))[0]
            leaves = flatten_with_path(getattr(state, tree))
            assert len(ref_leaves) == len(leaves)
            for (ka, a), (kb, b) in zip(ref_leaves, leaves):
                assert jax.tree_util.keystr(ka) == keystr(kb)
                np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-3, atol=1e-5,
                                           err_msg=keystr(kb))
        for name, mask in state.touched.items():
            np.testing.assert_array_equal(_np(mask), np.asarray(ref_state.touched[name]))
    return ref_state


def _snapshot_pair(ref_bundle, bundle, ref_state):
    """The same trained state as each package's snapshot."""
    return (ref_state_to_snapshot(ref_state, ref_bundle.tracked, {}),
            state_to_snapshot(state_from_numpy(_to_numpy(ref_state), "cpu"),
                              bundle.tracked, {}))


def _save_both(snaps, quant_key):
    q = QUANTS[quant_key]
    kw = dict(policy="one_shot", async_write=False, chunk_rows=64)
    ref_store, port_store = RefStore(), InMemoryStore()
    ref_mgr = RefManager(ref_store, RefConfig(quant=q and RefQuant(**q), **kw))
    mgr = CheckNRunManager(port_store, CheckpointConfig(
        quant=q and QuantConfig(**q), device="cpu", **kw))
    ref_mgr.save(snaps[0]).result()
    mgr.save(snaps[1]).result()
    ref_mgr.close()
    mgr.close()
    return ref_store, port_store


def _sections(data, ch, dim, bits):
    """scale, zero (fp16 on the wire) and codes of a quantized chunk."""
    sec = lambda n: data[ch.sections[n][0]:sum(ch.sections[n])]
    codes = packing.unpack_bits(sec("codes"), bits, ch.n_rows * dim)
    return (np.frombuffer(sec("scale"), np.float16), np.frombuffer(sec("zero"), np.float16),
            codes)


def _check_chunks(snaps, quant_key):
    """Chunk objects and dense blobs of one snapshot saved by both packages:
    byte-identical, except that 4-bit adaptive chunks need only meet the
    contract's tolerance."""
    ref_store, port_store = _save_both(snaps, quant_key)
    keys = sorted(ref_store.list("chunks/"))
    assert keys == sorted(port_store.list("chunks/")) and keys
    man = mf.load(port_store, snaps[1].step)
    records = {ch.key: (rec.dim, ch) for rec in man.tables.values() for ch in rec.chunks}
    for k in keys:
        a, b = ref_store.get(k), port_store.get(k)
        if a == b:
            continue
        assert quant_key == "a4" and k in records, k
        dim, ch = records[k]
        sa, za, ca = _sections(a, ch, dim, 4)
        sb, zb, cb = _sections(b, ch, dim, 4)
        np.testing.assert_allclose(sb.astype(np.float32), sa.astype(np.float32), rtol=1e-3)
        np.testing.assert_allclose(zb.astype(np.float32), za.astype(np.float32), rtol=1e-3,
                                   atol=1e-6)
        assert (ca != cb).mean() <= 2e-3, k
    return ref_store, port_store


def _restores(store):
    ref = RefManager(store, RefConfig(async_write=False))
    port = CheckNRunManager(store, CheckpointConfig(async_write=False, device="cpu"))
    try:
        return ref.restore(), port.restore()
    finally:
        ref.close()
        port.close()


def _assert_same_restore(a, b):
    assert a.step == b.step and sorted(a.tables) == sorted(b.tables)
    for n in a.tables:
        np.testing.assert_array_equal(a.tables[n], b.tables[n], err_msg=n)
        assert sorted(a.row_state[n]) == sorted(b.row_state[n])
        for k in a.row_state[n]:
            np.testing.assert_array_equal(a.row_state[n][k], b.row_state[n][k])
    assert sorted(a.dense) == sorted(b.dense)
    for k in a.dense:
        np.testing.assert_array_equal(a.dense[k], b.dense[k], err_msg=k)


def _check_cross_restore(snaps, quant_key, dense_keys):
    """Each package's store restores in the other to what the writer's own
    restore gives; the dense blobs named in ``dense_keys`` come back as the
    snapshot had them."""
    for store in _save_both(snaps, quant_key):
        ref_rs, port_rs = _restores(store)
        _assert_same_restore(ref_rs, port_rs)
        for k in dense_keys:
            np.testing.assert_array_equal(port_rs.dense[k], snaps[1].dense[k], err_msg=k)
            assert port_rs.dense[k].shape == snaps[1].dense[k].shape


def _check_cell_smoke(arch, shape):
    """The reduced analog of ``tests/test_models_smoke.py``'s cell smoke:
    the cell runs its step on its own inputs, whose shapes are
    ``make_inputs()``'s, and gives finite outputs."""
    bundle = get_cell(arch, shape, reduced=True, device="cpu")
    specs = bundle.make_inputs()
    batch = batch_for_cell(bundle, 0)
    assert {k: v.shape for k, v in batch.items()} == {k: s.shape for k, s in specs.items()}
    assert {k: v.dtype for k, v in batch.items()} == {k: np.dtype(s.dtype)
                                                      for k, s in specs.items()}
    state = bundle.make_state()
    if bundle.kind == "train":
        state, metrics = bundle.step_fn(state, batch_to_device(batch, "cpu"))
        assert state.step == 1 and np.isfinite(float(metrics["loss"]))
        assert all(bool(torch.isfinite(p).all()) for _, p in flatten_with_path(state.params))
        return None
    out = bundle.step_fn(state.params, batch_to_device(batch, "cpu"))
    assert bool(torch.isfinite(out).all())
    return out


# ----------------------------------------------------------------- MIND


@pytest.fixture(scope="module")
def cells():
    return _cells("mind")


@pytest.mark.parametrize("shape", SHAPES)
def test_batches_identical(shape):
    _check_batches("mind", shape)


def test_params_tree_and_snapshot_keys_match(cells):
    snap = _check_tree_and_snapshot(*cells)
    assert "params['routing_init']" in snap.dense and "opt['dense']['bilinear']" in snap.dense
    assert list(snap.tables) == ["item_0"]


@pytest.mark.parametrize("dtype,bar", [("float32", 1e-5), ("bfloat16", 1e-4)])
@pytest.mark.parametrize("seed", [0, 1])
def test_forwards_match_reference(dtype, bar, seed):
    ref_bundle, bundle, ref_state, np_state = _cells("mind", seed)
    ref_cfg, cfg = _cfgs(ref_bundle, bundle, dtype)
    params = state_from_numpy(np_state, "cpu").params
    b = ref_batch_for_cell(ref_get_cell("mind", "serve_bulk", reduced=True), seed)
    want = np.asarray(ref_mind.interests(ref_state.params, jnp.asarray(b["hist"]), ref_cfg))
    got = _np(mind.interests(params, torch.from_numpy(b["hist"]), cfg))
    assert got.shape == (b["hist"].shape[0], 4, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=bar, atol=bar)
    want = np.asarray(ref_mind.serve(ref_state.params, b, ref_cfg))
    got = _np(mind.serve(params, batch_to_device(b, "cpu"), cfg))
    np.testing.assert_allclose(got, want, rtol=bar, atol=bar)
    r = ref_batch_for_cell(ref_get_cell("mind", "retrieval_cand", reduced=True), seed)
    want = np.asarray(ref_mind.serve_retrieval(ref_state.params, r, ref_cfg))
    got = _np(mind.serve_retrieval(params, batch_to_device(r, "cpu"), cfg))
    assert got.shape == want.shape == (512,)
    np.testing.assert_allclose(got, want, rtol=bar, atol=bar)
    t = ref_batch_for_cell(ref_bundle, seed)
    ref_loss, ref_aux = ref_mind.train_loss(ref_state.params, t, ref_cfg)
    loss, aux = mind.train_loss(params, batch_to_device(t, "cpu"), cfg)
    assert abs(float(ref_loss) - float(loss)) <= bar * (1 + abs(float(ref_loss)))
    assert abs(float(ref_aux["accuracy"]) - float(aux["accuracy"])) < 1e-6
    np.testing.assert_array_equal(_np(aux["touched"]["item_0"]),
                                  np.asarray(ref_aux["touched"]["item_0"]))


def test_padding_gets_no_routing_weight(cells):
    """A pad position (id 0) changes nothing: the validity mask zeroes its
    weight after the softmax over interests."""
    _, bundle, _, np_state = cells
    params = state_from_numpy(np_state, "cpu").params
    hist = torch.tensor([[5, 9, 0, 0, 0, 0, 0, 0, 0, 0]], dtype=torch.int32)
    params2 = dict(params, tables=dict(item_0=params["tables"]["item_0"].clone()))
    params2["tables"]["item_0"][0] += 7.0   # the pad row's values do not matter
    a = mind.interests(params, hist, bundle.cfg)
    b = mind.interests(params2, hist, bundle.cfg)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_routing_init_is_trained(cells):
    ref_bundle, bundle, _, np_state = cells
    state = state_from_numpy(np_state, "cpu")
    new, _ = bundle.step_fn(state, batch_to_device(batch_for_cell(bundle, 0), "cpu"))
    assert not torch.equal(new.params["dense"]["routing_init"],
                           state.params["dense"]["routing_init"])
    assert float(new.opt_state["dense"]["routing_init"].abs().sum()) > 0


def test_train_steps_match_reference(cells):
    _check_train_steps(*cells, ref_mind.train_loss, mind.train_loss)


@pytest.mark.parametrize("quant_key", sorted(QUANTS))
def test_chunks_byte_identical(cells, quant_key):
    ref_bundle, bundle, ref_state, _ = cells
    _check_chunks(_snapshot_pair(ref_bundle, bundle, ref_state), quant_key)


@pytest.mark.parametrize("quant_key", sorted(QUANTS))
def test_restore_across_packages(cells, quant_key):
    ref_bundle, bundle, ref_state, _ = cells
    _check_cross_restore(_snapshot_pair(ref_bundle, bundle, ref_state), quant_key,
                         ["params['routing_init']", "params['bilinear']"])


@pytest.mark.parametrize("shape", SHAPES)
def test_cell_smoke(shape):
    out = _check_cell_smoke("mind", shape)
    if shape == "retrieval_cand":
        assert out.shape == (512,)
    elif out is not None:
        assert out.shape == (get_cell("mind", shape, reduced=True, device="cpu")
                             .make_inputs()["hist"].shape[0],)


def test_launchers_train_and_serve_mind_on_cpu(tmp_path, capsys):
    from repro_torch.launch import serve, train

    assert train.main(["--arch", "mind", "--shape", "train_batch", "--steps", "4",
                       "--interval", "2", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path)]) == 0
    assert "checkpoint bytes written" in capsys.readouterr().out
    assert serve.main(["--arch", "mind", "--ckpt-dir", str(tmp_path),
                       "--requests", "48", "--batch", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "from checkpoint step 4" in out and "host scores out" in out


def test_mind_takes_no_vocab_cap():
    with pytest.raises(ValueError, match="no vocab cap"):
        get_cell("mind", "serve_p99", reduced=True, device="cpu", vocab_cap=512)
