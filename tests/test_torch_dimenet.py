"""The port's DimeNet slice (``repro_torch.models.dimenet``, the gnn cells)
against the reference, on reduced DimeNet (2 blocks, hidden 16, 2
bilinear, 3 x 2 bases) and the reduced GNN shapes.

Both sides start from the same numbers: the reference's initial TrainState
carried into the port through ``state_from_numpy``, the same numpy batches.
Bars:
  * the bases at rtol 1e-5 / atol 1e-6 (libm's sin and cos against XLA's);
  * in f32, forwards, losses and gradients at rtol/atol 1e-4 (the port keeps
    the reference's op order: segment sums in index order, the bilinear
    product as XLA contracts it; what remains is XLA's arccos and GEMM
    blocking);
  * in bf16 (the published compute dtype), outputs at 2e-2 relative to
    their scale: a bf16 step is 2^-8 and the messages pass through 2 blocks
    of bf16 GEMMs whose sums round in another order.
Checkpoints: a molecule cell's species table saved by both packages gives
byte-identical chunk objects at ``quant=None`` and 4-bit uniform_asym, and
each package restores the other's store to the same tables and dense
arrays.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import _families as ref_fam
from repro.configs import get_cell as ref_get_cell
from repro.data import cells as ref_cells
from repro.models import dimenet as ref_dn
from repro_torch.configs import _families as fam
from repro_torch.configs import get_cell
from repro_torch.core import PAPER_DEFAULTS, CheckpointConfig, InMemoryStore
from repro_torch.data import cells
from repro_torch.models import dimenet as dn
from repro_torch.train.loop import Trainer, TrainerConfig, batch_to_device
from repro_torch.train.state import state_from_numpy
from test_torch_mind import (_check_batches, _check_chunks, _check_cross_restore,
                             _check_tree_and_snapshot, _np, _snapshot_pair, _to_numpy)

SHAPES = ["molecule", "full_graph_sm", "minibatch_lg", "ogb_products"]


def _cells(shape, seed=0):
    ref_bundle = ref_get_cell("dimenet", shape, reduced=True)
    bundle = get_cell("dimenet", shape, reduced=True, device="cpu")
    ref_state = ref_bundle.make_state(jax.random.key(seed))
    return ref_bundle, bundle, ref_state, _to_numpy(ref_state)


def _cfgs(ref_bundle, bundle, dtype):
    return (dataclasses.replace(ref_bundle.cfg, compute_dtype=getattr(jnp, dtype)),
            dataclasses.replace(bundle.cfg, compute_dtype=getattr(torch, dtype)))


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        scale = max(float(np.abs(want).max()), 1e-3)
        assert float(np.abs(got - want).max()) <= 2e-2 * scale


def test_bases_match_reference():
    cfg = get_cell("dimenet", "molecule", device="cpu").cfg
    ref_cfg = ref_get_cell("dimenet", "molecule").cfg
    rng = np.random.default_rng(0)
    d = np.concatenate([rng.uniform(0, 7, 500), [0.0, 1e-6, 5.0, 6.0]]).astype(np.float32)
    a = rng.uniform(0, np.pi, d.shape).astype(np.float32)
    np.testing.assert_allclose(_np(dn.rbf_basis(torch.from_numpy(d), cfg)),
                               np.asarray(ref_dn.rbf_basis(jnp.asarray(d), ref_cfg)),
                               rtol=1e-5, atol=1e-6)
    got = _np(dn.sbf_basis(torch.from_numpy(d), torch.from_numpy(a), cfg))
    assert got.shape == (d.size, 42)
    np.testing.assert_allclose(got, np.asarray(ref_dn.sbf_basis(jnp.asarray(d),
                                                                jnp.asarray(a), ref_cfg)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_batches_identical(shape):
    _check_batches("dimenet", shape)


@pytest.mark.parametrize("shape", ["molecule", "full_graph_sm"])
def test_params_tree_and_snapshot_keys_match(shape):
    snap = _check_tree_and_snapshot(*_cells(shape)[:4])
    assert "params['blocks']['w_bil']" in snap.dense
    assert "params['blocks']['mlp'][1]['b']" in snap.dense
    assert list(snap.tables) == (["species"] if shape == "molecule" else [])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ["molecule", "full_graph_sm", "minibatch_lg"])
def test_forward_serve_and_loss_match_reference(shape, dtype):
    ref_bundle, bundle, ref_state, np_state = _cells(shape)
    ref_cfg, cfg = _cfgs(ref_bundle, bundle, dtype)
    params = state_from_numpy(np_state, "cpu").params
    b = ref_cells.batch_for_cell(ref_bundle, 1)
    tb = batch_to_device(b, "cpu")
    want = np.asarray(ref_dn.serve(ref_state.params, b, ref_cfg))
    got = _np(dn.serve(params, tb, cfg))
    assert got.shape == want.shape and got.dtype == np.float32
    _close(got, want, dtype)
    if shape != "molecule":
        fwd = _np(dn.forward_flat(params, tb, cfg))
        np.testing.assert_array_equal(fwd, got)
    ref_loss, ref_aux = ref_dn.train_loss(ref_state.params, b, ref_cfg)
    loss, aux = dn.train_loss(params, tb, cfg)
    _close(np.float32(float(loss)), np.float32(float(ref_loss)), dtype)
    if shape == "molecule":
        np.testing.assert_array_equal(_np(aux["touched"]["species"]),
                                      np.asarray(ref_aux["touched"]["species"]))
    else:
        assert aux["touched"] == {} and ref_aux["touched"] == {}


def _without_self_loops(b):
    """A graph batch with each self-loop edge (src == dst) moved to the
    next node and its triplets rebuilt: the reference's gradient is NaN at a
    self-loop (ROADMAP C), so gradients are compared where it is defined."""
    b = dict(b)
    src, dst = b["edge_src"], b["edge_dst"].copy()
    loop = src == dst
    dst[loop] = (dst[loop] + 1) % b["features"].shape[0]
    T, E = b["tri_kj"].size, src.size
    b["edge_dst"] = dst
    b["tri_kj"], b["tri_ji"] = ref_cells.build_triplets(src, dst, cap=T // E + 1, total=T)
    return b


def _grads(ref_state, np_state, b, ref_cfg, cfg):
    ref_g = jax.grad(lambda p: ref_dn.train_loss(p, b, ref_cfg)[0])(ref_state.params)
    params = state_from_numpy(np_state, "cpu").params
    leaves = [t.requires_grad_(True) for t in jax.tree_util.tree_leaves(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    loss, _ = dn.train_loss(params, batch_to_device(b, "cpu"), cfg)
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(ref_g)], \
        [_np(g) for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("shape", ["molecule", "minibatch_lg"])
def test_gradients_match_reference(shape):
    """``train_loss``'s gradients in f32, every leaf, the species table's
    rows included; graph batches without their self-loops."""
    ref_bundle, bundle, ref_state, np_state = _cells(shape)
    ref_cfg, cfg = _cfgs(ref_bundle, bundle, "float32")
    b = ref_cells.batch_for_cell(ref_bundle, 2)
    if shape != "molecule":
        b = _without_self_loops(b)
        assert not (b["edge_src"] == b["edge_dst"]).any()
    ref_leaves, grads = _grads(ref_state, np_state, b, ref_cfg, cfg)
    assert len(ref_leaves) == len(grads)
    for a, g in zip(ref_leaves, grads):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(g, a, rtol=1e-3,
                                   atol=1e-4 * max(float(np.abs(a).max()), 1e-3))


def test_self_loop_gradients_are_finite_where_the_reference_nans():
    """A graph batch as drawn holds self-loops: the reference's gradients
    are NaN there (the norm of a zero vector), the port's are finite, and
    the losses agree."""
    ref_bundle, bundle, ref_state, np_state = _cells("full_graph_sm")
    ref_cfg, cfg = _cfgs(ref_bundle, bundle, "float32")
    b = ref_cells.batch_for_cell(ref_bundle, 2)
    assert (b["edge_src"] == b["edge_dst"]).any()
    ref_leaves, grads = _grads(ref_state, np_state, b, ref_cfg, cfg)
    assert not all(np.isfinite(a).all() for a in ref_leaves)
    assert all(np.isfinite(g).all() for g in grads)
    ref_loss = float(ref_dn.train_loss(ref_state.params, b, ref_cfg)[0])
    loss = float(dn.train_loss(state_from_numpy(np_state, "cpu").params,
                               batch_to_device(b, "cpu"), cfg)[0])
    assert abs(loss - ref_loss) <= 1e-4 * (1 + abs(ref_loss))


def test_segment_sum_adds_in_index_order():
    """bf16 adds rounded one at a time in index order equal XLA's CPU
    scatter-add bit for bit; ``index_add_`` does not."""
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(3000, 8)).astype(np.float32)
    seg = rng.integers(0, 40, 3000).astype(np.int32)
    want = np.asarray(jax.jit(lambda v, s: jax.ops.segment_sum(v, s, num_segments=50))(
        jnp.asarray(vals, jnp.bfloat16), jnp.asarray(seg)).astype(jnp.float32))
    got = dn.SegmentSum(torch.from_numpy(seg), 50)(
        torch.from_numpy(vals).to(torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(got, want)
    f32 = np.asarray(jax.jit(lambda v, s: jax.ops.segment_sum(v, s, num_segments=50))(
        jnp.asarray(vals), jnp.asarray(seg)))
    np.testing.assert_array_equal(dn.SegmentSum(torch.from_numpy(seg), 50)(
        torch.from_numpy(vals)).numpy(), f32)


@pytest.mark.parametrize("shape", SHAPES)
def test_build_triplets_identical(shape):
    bundle = get_cell("dimenet", shape, reduced=True, device="cpu")
    b = cells.batch_for_cell(bundle, 0)
    src, dst = b["edge_src"].reshape(-1, b["edge_src"].shape[-1]), \
        b["edge_dst"].reshape(-1, b["edge_dst"].shape[-1])
    T = b["tri_kj"].shape[-1]
    for s, d in zip(src, dst):
        want = ref_cells.build_triplets(s, d, cap=T // s.size + 1, total=T)
        got = cells.build_triplets(s, d, cap=T // s.size + 1, total=T)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype == np.int32


def test_build_triplets_at_minibatch_lg_full_edge_count():
    bundle = get_cell("dimenet", "minibatch_lg", device="cpu")
    specs = bundle.make_inputs()
    N, E = specs["features"].shape[0], specs["edge_src"].shape[0]
    T = specs["tri_kj"].shape[0]
    assert (N, E, T) == (169_984, 168_960, 337_920)
    rng = np.random.default_rng([0, 0, 7])
    src = rng.integers(0, N, size=E).astype(np.int32)
    dst = ((src.astype(np.int64) * 131 + rng.integers(0, N, size=E)) % N).astype(np.int32)
    want = ref_cells.build_triplets(src, dst, cap=T // E + 1, total=T)
    got = cells.build_triplets(src, dst, cap=T // E + 1, total=T)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shape", SHAPES)
def test_full_cell_specs_and_flops_match_reference(shape):
    ref_bundle = ref_get_cell("dimenet", shape)
    bundle = get_cell("dimenet", shape, device="cpu")
    want = {k: (tuple(v.shape), np.dtype(v.dtype)) for k, v in ref_bundle.make_inputs().items()}
    got = {k: (tuple(v.shape), np.dtype(v.dtype)) for k, v in bundle.make_inputs().items()}
    assert got == want
    assert bundle.model_flops == ref_bundle.model_flops
    assert (fam.dimenet_flops(bundle.cfg, 10, 20, 40, 3)
            == ref_fam.dimenet_flops(ref_bundle.cfg, 10, 20, 40, 3))
    assert dataclasses.asdict(bundle.cfg) | {"compute_dtype": None} == \
        dataclasses.asdict(ref_bundle.cfg) | {"compute_dtype": None}
    for path in ("['tables']['species']", "['dense']['blocks']['w_bil']"):
        assert bundle.param_axes_fn(path, (4, 8)) == ref_bundle.param_axes_fn(path, (4, 8))


@pytest.mark.parametrize("shape", SHAPES)
def test_cell_smoke_trainer_with_saves(shape):
    """ROADMAP A6.3's gate, reduced: each GNN cell trains 4 steps through
    saves every 2 steps, and a fresh Trainer resumes from the store."""
    bundle = get_cell("dimenet", shape, reduced=True, device="cpu")
    store = InMemoryStore()
    ckpt = CheckpointConfig(interval_batches=2, policy="intermittent",
                            quant=PAPER_DEFAULTS[4], async_write=False, device="cpu")
    tr = Trainer(bundle, store, ckpt, TrainerConfig(total_steps=4, log_every=1))
    assert tr.init_or_restore() == 0
    tr.run(4)
    tr.close()
    assert len(tr.history) == 4 and all(np.isfinite(h["loss"]) for h in tr.history)
    tr2 = Trainer(bundle, store, ckpt, TrainerConfig(total_steps=1, log_every=1))
    assert tr2.init_or_restore() == 4
    for a, b in zip(jax.tree_util.tree_leaves(tr.state.params["dense"], is_leaf=torch.is_tensor),
                    jax.tree_util.tree_leaves(tr2.state.params["dense"], is_leaf=torch.is_tensor)):
        assert torch.equal(a, b)  # dense blobs are stored whole
    for name, live in tr.state.params["tables"].items():  # 4-bit adaptive rows
        got = tr2.state.params["tables"][name]
        assert float((got - live).abs().mean() / live.abs().mean()) < 0.1
    tr2.run(1)
    tr2.close()


@pytest.mark.parametrize("quant_key", ["none", "u4"])
def test_molecule_chunks_byte_identical(quant_key):
    ref_bundle, bundle, ref_state, _ = _cells("molecule")
    _check_chunks(_snapshot_pair(ref_bundle, bundle, ref_state), quant_key)


@pytest.mark.parametrize("quant_key", ["none", "u4"])
def test_restore_across_packages(quant_key):
    ref_bundle, bundle, ref_state, _ = _cells("molecule")
    _check_cross_restore(_snapshot_pair(ref_bundle, bundle, ref_state), quant_key,
                         ["params['blocks']['w_bil']", "params['edge_mlp'][0]['w']"])


def test_launcher_trains_dimenet_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    assert train.main(["--arch", "dimenet", "--shape", "molecule", "--steps", "4",
                       "--interval", "2", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path)]) == 0
    assert "checkpoint bytes written" in capsys.readouterr().out
