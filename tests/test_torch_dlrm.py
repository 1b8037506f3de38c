"""The port's DLRM train step against the reference's, on reduced dlrm-rm2.

Both sides compute in float32 and start from the same numbers: the
reference's initial TrainState is carried into the port through
``state_from_numpy``, and both draw the same numpy batches. Tolerances are
the bars the reference holds its sharded step to
(``tests/test_distribution.py``): loss within 1e-4, tables at rtol 1e-3 /
atol 1e-5. They allow for sums taken in another order: the matmuls, and the
per-id gradient aggregation, which is ``index_add_`` here (on a card its
atomics add in no fixed order) and a sorted segment-sum in the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_cell as ref_get_cell
from repro.data.cells import batch_for_cell as ref_batch_for_cell
from repro.dist.sharding import NO_SHARDING
from repro.models import dlrm as ref_dlrm
from repro.optim.optimizers import adagrad as ref_adagrad
from repro.train.state import state_to_snapshot as ref_state_to_snapshot
from repro_torch.configs import get_cell
from repro_torch.data.cells import batch_for_cell
from repro_torch.models import dlrm
from repro_torch.optim.optimizers import adagrad
from repro_torch.train.loop import batch_to_device
from repro_torch.train.state import state_from_numpy, state_to_snapshot


@pytest.fixture(scope="module")
def cells():
    ref_bundle = ref_get_cell("dlrm-rm2", "train_batch", reduced=True)
    bundle = get_cell("dlrm-rm2", "train_batch", reduced=True, device="cpu")
    ref_cfg = dataclasses.replace(ref_bundle.cfg, compute_dtype=jnp.float32)
    cfg = dataclasses.replace(bundle.cfg, compute_dtype=torch.float32)
    ref_step = jax.jit(ref_dlrm.make_sparse_train_step(ref_cfg, NO_SHARDING,
                                                       ref_adagrad(0.01)))
    step = dlrm.make_sparse_train_step(cfg, adagrad(0.01))
    ref_state = ref_bundle.make_state()  # immutable: shared by the tests
    return ref_bundle, bundle, ref_step, step, ref_state, _to_numpy(ref_state)


def _to_numpy(ref_state):
    tree = lambda t: jax.tree.map(lambda a: np.array(a), t)
    return dict(step=np.asarray(ref_state.step), params=tree(ref_state.params),
                opt_state=tree(ref_state.opt_state), touched=tree(ref_state.touched),
                rng=np.asarray(jax.random.key_data(ref_state.rng)))


def _np(t):
    return t.detach().cpu().numpy()


def test_batches_identical(cells):
    ref_bundle, bundle = cells[:2]
    for i in (0, 3):
        a, b = ref_batch_for_cell(ref_bundle, i), batch_for_cell(bundle, i)
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype


def test_snapshot_keys_and_arrays_match(cells):
    ref_bundle, bundle, _, _, ref_state, np_state = cells
    state = state_from_numpy(np_state, "cpu")
    a = ref_state_to_snapshot(ref_state, ref_bundle.tracked, {})
    b = state_to_snapshot(state, bundle.tracked, {})
    assert list(a.dense) == list(b.dense)
    assert "params['bot'][0]['w']" in b.dense and "opt['dense']['top'][2]['b']" in b.dense
    for k in a.dense:
        assert a.dense[k].dtype == b.dense[k].dtype and a.dense[k].shape == b.dense[k].shape, k
        assert a.dense[k].tobytes() == b.dense[k].tobytes(), k
    assert b.dense["rng"].dtype == np.uint32 and b.dense["rng"].shape == (2,)
    for n in a.tables:
        assert a.tables[n].tobytes() == b.tables[n].tobytes()
        assert a.row_state[n]["opt_acc"].tobytes() == b.row_state[n]["opt_acc"].tobytes()
        np.testing.assert_array_equal(a.touched[n], b.touched[n])


def test_sparse_steps_match_reference(cells):
    ref_bundle, bundle, ref_step, step, ref_state, np_state = cells
    state = state_from_numpy(np_state, "cpu")
    for i in range(2):  # the second step starts from non-zero accumulators
        batch = ref_batch_for_cell(ref_bundle, i)
        ref_state, ref_m = ref_step(ref_state, batch)
        state, m = step(state, batch_to_device(batch, "cpu"))
        assert abs(float(ref_m["loss"]) - float(m["loss"])) < 1e-4
        assert state.step == int(ref_state.step) == i + 1
        for n, t in ref_state.params["tables"].items():
            np.testing.assert_allclose(_np(state.params["tables"][n]), np.asarray(t),
                                       rtol=1e-3, atol=1e-5, err_msg=n)
            np.testing.assert_allclose(_np(state.opt_state["tables"][n]),
                                       np.asarray(ref_state.opt_state["tables"][n]),
                                       rtol=1e-3, err_msg=n)
            np.testing.assert_array_equal(_np(state.touched[n]),
                                          np.asarray(ref_state.touched[n]))
        for (ka, a), (kb, b) in zip(
                jax.tree_util.tree_flatten_with_path(ref_state.params["dense"])[0],
                jax.tree_util.tree_flatten_with_path(
                    jax.tree.map(np.asarray, _dense_numpy(state)))[0]):
            assert jax.tree_util.keystr(ka) == jax.tree_util.keystr(kb)
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-3, atol=1e-5)


def _dense_numpy(state):
    from repro_torch.tree import tree_map
    return tree_map(_np, state.params["dense"])


def test_dense_path_loss_matches_reference(cells):
    """``train_loss`` (the table-gradient path) on the same params/batch."""
    ref_bundle, bundle, _, _, ref_state, np_state = cells
    ref_cfg = dataclasses.replace(ref_bundle.cfg, compute_dtype=jnp.float32)
    cfg = dataclasses.replace(bundle.cfg, compute_dtype=torch.float32)
    state = state_from_numpy(np_state, "cpu")
    batch = ref_batch_for_cell(ref_bundle, 5)
    ref_loss, ref_aux = ref_dlrm.train_loss(ref_state.params, batch, ref_cfg)
    loss, aux = dlrm.train_loss(state.params, batch_to_device(batch, "cpu"), cfg)
    assert abs(float(ref_loss) - float(loss)) < 1e-4
    assert abs(float(ref_aux["accuracy"]) - float(aux["accuracy"])) < 1e-6
    for n, mask in ref_aux["touched"].items():
        np.testing.assert_array_equal(_np(aux["touched"][n]), np.asarray(mask))


def test_dot_interaction_order():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(3, 5, 4)).astype(np.float32)
    ref = np.asarray(ref_dlrm.dot_interaction(jnp.asarray(feats)))
    got = _np(dlrm.dot_interaction(torch.from_numpy(feats)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
