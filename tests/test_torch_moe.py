"""The port's mixture-of-experts LMs (``repro_torch.models.layers.moe_ffn``,
olmoe-1b-7b and dbrx-132b through ``models.transformer``) against the
reference, on their reduced configs (2 layers, d 64, 8 or 4 experts).

Both sides start from the same numbers: the reference's parameters carried
into the port through numpy, the same numpy inputs. Bars, in f32 compute:
  * ``moe_ffn``: the output at rtol/atol 1e-5 (the grouped products and
    the combine sum in another order), the touched mask equal, the aux loss
    at 1e-6;
  * the models' forward, loss and gradients at the transformer tests' f32
    bars (1e-4; gradients rtol 1e-3).
Routing is compared only where it cannot flip: top-k over f32
probabilities that the packages compute an ulp apart can swap two experts
whose probabilities tie. So every test that holds routed outputs equal
first asserts that each token's k-th and (k+1)-th probabilities lie more
than ``MARGIN`` apart (in the port's router, whose probabilities agree
with the reference's to about 1e-7).
Checkpoints: the expert specs (one unit a (layer, expert)) and ``tok_emb``
saved by both packages give byte-identical chunks at ``quant=None`` and
4-bit uniform_asym, and each package restores the other's store; the
counterparts of ``tests/test_moe_checkpoint.py`` and of
``test_models_smoke.py::test_loss_decreases`` for olmoe.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import _module as ref_module
from repro.data.cells import batch_for_cell as ref_batch_for_cell
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tf
from repro_torch.configs import _module, get_cell
from repro_torch.core import CheckNRunManager, CheckpointConfig, InMemoryStore, Snapshot
from repro_torch.data.cells import batch_for_cell
from repro_torch.models import layers, transformer as tf
from repro_torch.train.loop import Trainer, TrainerConfig, batch_to_device
from repro_torch.train.state import state_from_numpy
from repro_torch.tree import flatten_with_path, keystr
from test_torch_mind import (_check_chunks, _check_cross_restore, _check_tree_and_snapshot,
                             _np, _snapshot_pair)
from test_torch_transformer import _cells, _cfgs, _f32

ARCHS = ["olmoe-1b-7b", "dbrx-132b"]
MARGIN = 1e-5


def _margin(probs: torch.Tensor, k: int) -> float:
    """The least gap, over tokens, between the k-th and (k+1)-th largest
    routing probabilities."""
    top = torch.topk(probs.detach(), k + 1, dim=-1).values
    return float((top[:, k - 1] - top[:, k]).min())


@contextlib.contextmanager
def _router_margins(monkeypatch, out: list):
    """Record each call's routing margin from the port's router."""
    router = layers._moe_router

    def recording(xf, w, top_k):
        probs, weights, ids = router(xf, w, top_k)
        out.append(_margin(probs, top_k))
        return probs, weights, ids

    monkeypatch.setattr(layers, "_moe_router", recording)
    yield out


def _ref_moe_params(arch, seed=0):
    ref_cfg = ref_module(arch).make_config(reduced=True)
    p = ref_layers.moe_params_init(jax.random.key(seed), ref_cfg.d_model, ref_cfg.moe)
    return ref_cfg, p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _port_moe_cfg(ref_moe):
    return layers.MoEConfig(**dataclasses.asdict(ref_moe))


# ------------------------------------------------------------------ layer


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch):
    ref_cfg, ref_p, p = _ref_moe_params(arch)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 16, ref_cfg.d_model)).astype(np.float32)
    k = ref_cfg.moe.top_k
    probs, weights, ids = layers._moe_router(torch.from_numpy(x).reshape(-1, x.shape[-1]),
                                             p["router"], k)
    assert _margin(probs, k) > MARGIN
    ref_probs, ref_w, ref_ids = ref_layers._moe_router(
        jnp.asarray(x).reshape(-1, x.shape[-1]), ref_p["router"], k)
    np.testing.assert_array_equal(_np(ids), np.asarray(ref_ids))
    np.testing.assert_allclose(_np(probs), np.asarray(ref_probs), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(weights), np.asarray(ref_w), rtol=1e-6, atol=1e-7)

    want, want_t, want_aux = ref_layers.moe_ffn(jnp.asarray(x), ref_p, ref_cfg.moe,
                                                compute_dtype=jnp.float32)
    got, got_t, got_aux = layers.moe_ffn(torch.from_numpy(x), p, _port_moe_cfg(ref_cfg.moe),
                                         compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_np(got_t), np.asarray(want_t))
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_bf16_operands_give_f32_products(arch):
    """In bf16 compute the grouped products take bf16 operands and return
    f32 (``ragged_dot``'s ``preferred_element_type``): the port's output
    is the reference's within a bf16 ulp of the output's scale."""
    ref_cfg, ref_p, p = _ref_moe_params(arch, seed=2)
    x = np.random.default_rng(3).normal(size=(2, 8, ref_cfg.d_model)).astype(np.float32)
    k = ref_cfg.moe.top_k
    probs, _, _ = layers._moe_router(torch.from_numpy(x).reshape(-1, x.shape[-1]),
                                     p["router"], k)
    assert _margin(probs, k) > MARGIN
    want, want_t, _ = ref_layers.moe_ffn(jnp.asarray(x), ref_p, ref_cfg.moe)
    got, got_t, _ = layers.moe_ffn(torch.from_numpy(x), p, _port_moe_cfg(ref_cfg.moe))
    scale = float(np.abs(np.asarray(want)).max())
    assert float(np.abs(_np(got) - np.asarray(want)).max()) <= 2 ** -8 * scale
    np.testing.assert_array_equal(_np(got_t), np.asarray(want_t))


def test_moe_expert_parallel_dispatch_waits_for_the_mesh_slice():
    """``"ep"`` runs across the ranks of a mesh that carries a process
    group (``tests/test_torch_moe_ep.py``); without one, or on an abstract
    mesh, it raises a ValueError that says so, and never falls back to the
    dense dispatch."""
    from repro_torch.dist.sharding import lm_rules
    from repro_torch.launch.mesh import Mesh, make_production_mesh

    ref_cfg, _, p = _ref_moe_params("olmoe-1b-7b")
    cfg = dataclasses.replace(_port_moe_cfg(ref_cfg.moe), dispatch="ep")
    x = torch.zeros((1, 4, ref_cfg.d_model))
    with pytest.raises(ValueError, match="process group|torch.distributed group"):
        layers.moe_ffn(x, p, cfg)
    rules = lm_rules(make_production_mesh())
    with pytest.raises(ValueError, match="torch.distributed group"):
        layers.moe_ffn(x, p, cfg, rules=rules)
    auto = dataclasses.replace(cfg, dispatch="auto")
    with pytest.raises(ValueError, match="torch.distributed group"):
        # auto takes ep where the model axis divides the 8 experts
        layers.moe_ffn(x, p, auto, rules=lm_rules(Mesh({"data": 2, "model": 4})))
    # ... and dense where it does not (16), as the reference's
    got = layers.moe_ffn(x, p, auto, rules=rules)[0]
    assert torch.equal(got, layers.moe_ffn(x, p, dataclasses.replace(cfg, dispatch="dense"))[0])
    with pytest.raises(ValueError, match="unknown MoE dispatch"):
        layers.moe_ffn(x, p, dataclasses.replace(cfg, dispatch="sparse"))


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("arch", ARCHS)
def test_params_tree_and_snapshot_keys_match(arch):
    snap = _check_tree_and_snapshot(*_cells(arch))
    assert sorted(snap.tables) == ["moe_w_down", "moe_w_gate", "moe_w_up", "tok_emb"]
    assert "params['blocks']['moe']['router']" in snap.dense
    assert "params['blocks']['moe']['w_up']" not in snap.dense
    cfg = _module(arch).make_config(reduced=True)
    L, E = cfg.n_layers, cfg.moe.n_experts
    assert snap.tables["moe_w_up"].shape == (L * E * cfg.d_model, cfg.moe.d_ff)
    assert snap.row_state["moe_w_up"]["opt_acc2d"].shape == snap.tables["moe_w_up"].shape


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch, monkeypatch):
    ref_bundle, bundle, ref_state, np_state = _cells(arch)
    ref_cfg, cfg = _cfgs(arch, "float32")
    params = state_from_numpy(np_state, "cpu").params
    b = ref_batch_for_cell(ref_bundle, 1)
    tb = batch_to_device(b, "cpu")
    margins = []
    with _router_margins(monkeypatch, margins), torch.no_grad():
        h, _, touched, aux = tf.forward(params, tb["tokens"], cfg)
    assert len(margins) == cfg.n_layers and min(margins) > MARGIN
    h_ref, _, ref_touched, ref_aux = ref_tf.forward(ref_state.params,
                                                    jnp.asarray(b["tokens"]), ref_cfg)
    np.testing.assert_allclose(_np(h), _f32(h_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(_np(touched), np.asarray(ref_touched))
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)
    ref_loss, ref_out = ref_tf.train_loss(ref_state.params, b, ref_cfg)
    loss, out = tf.train_loss(params, tb, cfg)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(out["aux_loss"]), float(ref_out["aux_loss"]), rtol=1e-5)
    assert sorted(out["touched"]) == sorted(ref_out["touched"])
    for name, mask in out["touched"].items():
        np.testing.assert_array_equal(_np(mask), np.asarray(ref_out["touched"][name]),
                                      err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch, monkeypatch):
    """``train_loss``'s gradients in f32, every leaf: the experts', the
    router's (through the weights and the aux loss) and the rest."""
    ref_bundle, bundle, ref_state, np_state = _cells(arch)
    ref_cfg, cfg = _cfgs(arch, "float32")
    b = ref_batch_for_cell(ref_bundle, 2)
    ref_g = jax.grad(lambda p: ref_tf.train_loss(p, b, ref_cfg)[0])(ref_state.params)
    params = state_from_numpy(np_state, "cpu").params
    leaves = [t.requires_grad_(True) for _, t in flatten_with_path(params)]
    margins = []
    with _router_margins(monkeypatch, margins):
        loss, _ = tf.train_loss(params, batch_to_device(b, "cpu"), cfg)
    assert min(margins) > MARGIN
    grads = torch.autograd.grad(loss, leaves)
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_g)[0]
    assert [jax.tree_util.keystr(p) for p, _ in ref_leaves] == [
        keystr(p) for p, _ in flatten_with_path(params)]
    for (path, a), g in zip(ref_leaves, grads):
        a = np.asarray(a)
        np.testing.assert_allclose(_np(g), a, rtol=1e-3,
                                   atol=1e-4 * max(float(np.abs(a).max()), 1e-6),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, monkeypatch):
    ref_bundle, bundle, ref_state, np_state = _cells(arch, "prefill_32k")
    ref_cfg, cfg = _cfgs(arch, "float32")
    params = state_from_numpy(np_state, "cpu").params
    tokens = ref_batch_for_cell(ref_bundle, 0)["tokens"]
    want, ref_caches = ref_tf.prefill_step(ref_state.params, jnp.asarray(tokens), ref_cfg)
    margins = []
    with _router_margins(monkeypatch, margins):
        got, caches = tf.prefill_step(params, torch.from_numpy(tokens), cfg)
    assert min(margins) > MARGIN
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(caches[k]), np.asarray(ref_caches[k]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("quant_key", ["none", "u4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_chunks_byte_identical(arch, quant_key):
    ref_bundle, bundle, ref_state, _ = _cells(arch)
    ref_store, _ = _check_chunks(_snapshot_pair(ref_bundle, bundle, ref_state), quant_key)
    assert any("moe_w_up" in k for k in ref_store.list("chunks/"))


@pytest.mark.parametrize("quant_key", ["none", "u4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_restore_across_packages(arch, quant_key):
    ref_bundle, bundle, ref_state, _ = _cells(arch)
    _check_cross_restore(_snapshot_pair(ref_bundle, bundle, ref_state), quant_key,
                         ["params['blocks']['moe']['router']", "params['w_out']"])


# ------------------------------------------- tests/test_moe_checkpoint.py


def _flat(tree):
    return {keystr(p): _np(t) for p, t in flatten_with_path(tree)}


def test_moe_expert_restore_bit_exact():
    b = get_cell("olmoe-1b-7b", "train_4k", reduced=True, device="cpu")
    assert any(s.expansion > 1 for s in b.tracked.values())  # expert specs
    store = InMemoryStore()
    cfg = CheckpointConfig(interval_batches=2, policy="one_shot", quant=None,
                           async_write=False, device="cpu")
    t = Trainer(b, store, cfg, TrainerConfig(total_steps=4, use_reader_tier=False))
    t.init_or_restore()
    t.run(4)
    ref_p, ref_o = _flat(t.state.params), _flat(t.state.opt_state)
    t.close()
    t2 = Trainer(b, store, cfg, TrainerConfig(total_steps=4, use_reader_tier=False))
    assert t2.init_or_restore() == 4
    got_p, got_o = _flat(t2.state.params), _flat(t2.state.opt_state)
    assert sorted(got_p) == sorted(ref_p) and sorted(got_o) == sorted(ref_o)
    for k in ref_p:
        np.testing.assert_array_equal(ref_p[k], got_p[k], err_msg=k)
    for k in ref_o:
        np.testing.assert_array_equal(ref_o[k], got_o[k], err_msg=k)
    t2.close()


def test_moe_increment_smaller_when_few_experts_touched():
    """With top-k routing, an interval that touches a subset of experts
    yields an increment smaller than a full expert dump."""
    rng = np.random.default_rng(0)
    L, E, d, F = 2, 8, 16, 32
    w = rng.normal(size=(L * E * d, F)).astype(np.float32)
    mgr = CheckNRunManager(InMemoryStore(), CheckpointConfig(
        policy="one_shot", quant=None, async_write=False, device="cpu"))
    full_mask = np.ones(L * E * d, dtype=bool)
    r1 = mgr.save(Snapshot(step=1, tables={"w_up": w.copy()}, row_state={"w_up": {}},
                           touched={"w_up": full_mask}, dense={}, extra={})).result()
    partial = np.zeros(L * E * d, dtype=bool)  # 2 of 16 (layer, expert) units
    partial[:2 * d] = True
    w[:2 * d] += 0.1
    r2 = mgr.save(Snapshot(step=2, tables={"w_up": w.copy()}, row_state={"w_up": {}},
                           touched={"w_up": partial}, dense={}, extra={})).result()
    assert r2.kind == "incremental"
    assert r2.nbytes < 0.2 * r1.nbytes
    np.testing.assert_array_equal(mgr.restore().tables["w_up"], w)
    mgr.close()


def test_trained_expert_units_are_the_routed_ones():
    """A step's expert touched mask (L*E units) marks exactly the (layer,
    expert) pairs its tokens were routed to, and the snapshot expands it to
    the experts' rows."""
    b = get_cell("olmoe-1b-7b", "train_4k", reduced=True, device="cpu")
    cfg = b.cfg
    state = b.make_state()
    batch = batch_to_device(batch_for_cell(b, 0), "cpu")
    with torch.no_grad():
        _, _, touched, _ = tf.forward(state.params, batch["tokens"], cfg)
    state2, _ = b.step_fn(state, batch)
    mask = state2.touched["moe_w_up"]
    assert mask.shape == (cfg.n_layers * cfg.moe.n_experts,)
    np.testing.assert_array_equal(_np(mask), _np(touched.reshape(-1)))
    assert torch.equal(state2.touched["moe_w_gate"], mask)
    assert torch.equal(state2.touched["moe_w_down"], mask)


# ----------------------------------------- test_models_smoke.py's loss test


def test_loss_decreases():
    """A few steps of olmoe training reduce the loss on the synthetic
    stream, as ``tests/test_models_smoke.py::test_loss_decreases``."""
    bundle = get_cell("olmoe-1b-7b", "train_4k", reduced=True, device="cpu")
    state = bundle.make_state()
    losses = []
    for i in range(15):
        state, m = bundle.step_fn(state, batch_to_device(batch_for_cell(bundle, i % 3), "cpu"))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
