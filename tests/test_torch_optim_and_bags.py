"""The port's ``sgd`` and ``adamw`` (``repro_torch.optim``) and its
``embedding_bag`` and ``ragged_embedding_bag`` (``repro_torch.models.
embedding``) against the reference's, on the same numpy inputs.

The optimizers run three steps over one parameter tree (a dict, a list and
a 0-d leaf) from the same gradients; the bags take every mode, with and
without per-id weights, and ragged offsets with an empty bag. The
optimizers, the max bag and the ragged bags do the same f32 arithmetic in
the same order on both sides and are held bit for bit; XLA sums a bag of 5
rows in another order than PyTorch, so the sum and mean bags are held at
rtol 1e-5 / atol 1e-6 (they differ by an f32 ulp or two).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import embedding as ref_emb
from repro.optim import optimizers as ref_opt
from repro_torch.models import embedding
from repro_torch.optim import adamw, apply_updates, optimizers, sgd
from repro_torch.tree import tree_map

OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd_momentum": lambda m: m.sgd(0.1, momentum=0.9),
    "adamw": lambda m: m.adamw(0.01),
    "adamw_decay": lambda m: m.adamw(0.01, b1=0.8, b2=0.99, weight_decay=0.1),
}


def _params(rng):
    return {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "b": [rng.normal(size=(4,)).astype(np.float32),
                  np.asarray(rng.normal(), np.float32)]}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(name):
    rng = np.random.default_rng(0)
    params = _params(rng)
    ref, port = OPTIMIZERS[name](ref_opt), OPTIMIZERS[name](optimizers)
    rp, pp = jax.tree.map(jnp.asarray, params), tree_map(torch.tensor, params)
    rs, ps = ref.init(rp), port.init(pp)
    for _ in range(3):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        ru, rs = ref.update(jax.tree.map(jnp.asarray, g), rs, rp)
        pu, ps = port.update(tree_map(torch.tensor, g), ps, pp)
        rp, pp = ref_opt.apply_updates(rp, ru), apply_updates(pp, pu)
    for a, b in zip(jax.tree.leaves(rp), jax.tree.leaves(pp)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
    for a, b in zip(jax.tree.leaves(rs), jax.tree.leaves(ps)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_optimizer_states():
    """sgd without momentum keeps no state; adamw counts steps in an int32
    scalar beside its two moment trees."""
    params = {"w": torch.zeros((2, 2))}
    assert sgd(0.1).init(params) == ()
    st = adamw(0.01).init(params)
    assert sorted(st) == ["count", "mu", "nu"]
    assert st["count"].dtype == torch.int32 and st["count"].shape == ()
    _, st = adamw(0.01).update({"w": torch.ones((2, 2))}, st, params)
    assert int(st["count"]) == 1 and st["count"].dtype == torch.int32


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_reference(mode, weighted):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(50, 6)).astype(np.float32)
    ids = rng.integers(0, 50, size=(4, 3, 5)).astype(np.int32)
    w = rng.normal(size=(4, 3, 5)).astype(np.float32) if weighted else None
    want = np.asarray(ref_emb.embedding_bag(jnp.asarray(table), jnp.asarray(ids), mode,
                                            None if w is None else jnp.asarray(w)))
    got = embedding.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), mode,
                                  None if w is None else torch.from_numpy(w))
    assert got.shape == (4, 3, 6)
    if mode == "max":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        embedding.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), "min")


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_ragged_embedding_bag_matches_reference(mode):
    """Bags of 2, 0, 5 and 2 ids: the empty bag is zeros (``mean`` divides
    by max(count, 1))."""
    rng = np.random.default_rng(2)
    table = rng.normal(size=(30, 4)).astype(np.float32)
    values = rng.integers(0, 30, size=9).astype(np.int32)
    offsets = np.array([0, 2, 2, 7, 9], np.int32)
    want = np.asarray(ref_emb.ragged_embedding_bag(
        jnp.asarray(table), jnp.asarray(values), jnp.asarray(offsets), 4, mode))
    got = embedding.ragged_embedding_bag(torch.from_numpy(table), torch.from_numpy(values),
                                         torch.from_numpy(offsets), 4, mode)
    assert got.shape == (4, 4) and not got[1].any()
    np.testing.assert_array_equal(got.numpy(), want)
