"""The port's xDeepFM slice (``repro_torch.models.xdeepfm``) against the
reference, on reduced xDeepFM (39 fields of 16-100 rows, dim 4, CIN 8-8,
MLP 16-16).

Both sides start from the same numbers (the reference's initial
TrainState through ``state_from_numpy``) and draw the same numpy batches.
The CIN runs field-major in the port (one (H_k, H_{k-1} F) x (H_{k-1} F,
B D) product a layer, where the reference contracts a (B, H, F, D) einsum),
so its sums are taken in another order. Its outputs and the logits are
sums of terms that cancel, so they are held against their largest value;
the probabilities (``serve``, ``serve_retrieval``) absolutely, the loss
relative to itself. Each bar is the tightest that held over 5 seeds of
16,384 rows, with margin (worst seen in brackets): in f32 the CIN 1e-5 of
its largest value (9.2e-7), logits 1e-5 (7.9e-7), probabilities 5e-5
(1.6e-5), the loss 1e-5; in bf16, where a CIN output one bf16 ulp apart
moves a logit by up to 0.125, the CIN 1e-3 (1.9e-4), logits 5e-3 (2.5e-3),
probabilities 2e-2 (0.0153; ROADMAP's bf16 serve bar), the loss 1e-4. One
train step is held at ``tests/test_torch_dlrm.py``'s bars.
Checkpoints as ``tests/test_torch_mind.py`` holds them, over both table
families: ``emb_*`` (dim 4 here, 10 at full width) and ``lin_*`` (dim 1),
and the dense blobs ``cin/*``, ``cin_out`` and the 0-d ``bias``. A dim-1
table at 4-bit restores as the fp16 rounding of each value (a row of one
value has no range: scale 1, code 0, and the zero, stored as fp16, is the
value). Retrieval scores whole chunks of 8,192 candidates only: 999,424 of
the full cell's 1,000,000.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_cell as ref_get_cell
from repro.data.cells import batch_for_cell as ref_batch_for_cell
from repro.dist.sharding import NO_SHARDING
from repro.models import xdeepfm as ref_xdeepfm
from repro.models.embedding import lookup_fields as ref_lookup_fields
from repro_torch.configs import get_cell
from repro_torch.core import PAPER_DEFAULTS, CheckNRunManager, CheckpointConfig, InMemoryStore
from repro_torch.models import xdeepfm
from repro_torch.train.loop import batch_to_device
from repro_torch.train.state import state_from_numpy
from test_torch_mind import (
    QUANTS,
    SHAPES,
    _cells,
    _cfgs,
    _check_batches,
    _check_cell_smoke,
    _check_chunks,
    _check_cross_restore,
    _check_train_steps,
    _check_tree_and_snapshot,
    _np,
    _restores,
    _save_both,
    _snapshot_pair,
)


@pytest.fixture(scope="module")
def cells():
    return _cells("xdeepfm")


@pytest.mark.parametrize("shape", SHAPES)
def test_batches_identical(shape):
    _check_batches("xdeepfm", shape)


def test_params_tree_and_snapshot_keys_match(cells):
    snap = _check_tree_and_snapshot(*cells)
    assert snap.dense["params['bias']"].shape == ()
    assert snap.dense["params['cin'][1]"].shape == (8, 8, 39)
    assert "params['cin_out']" in snap.dense and "opt['dense']['cin'][0]" in snap.dense
    assert sorted(snap.tables) == sorted([f"emb_{i}" for i in range(39)]
                                         + [f"lin_{i}" for i in range(39)])
    assert all(snap.tables[f"lin_{i}"].shape[1] == 1 for i in range(39))


# dtype: bars for the CIN and the logits (of their largest value), the
# probabilities (absolute) and the loss (relative)
BARS = {"float32": (1e-5, 1e-5, 5e-5, 1e-5), "bfloat16": (1e-3, 5e-3, 2e-2, 1e-4)}


@pytest.mark.parametrize("dtype", sorted(BARS))
@pytest.mark.parametrize("seed", [0, 1])
def test_forwards_match_reference(dtype, seed):
    cin_bar, logit_bar, prob_bar, loss_bar = BARS[dtype]
    ref_bundle, bundle, ref_state, np_state = _cells("xdeepfm", seed)
    ref_cfg, cfg = _cfgs(ref_bundle, bundle, dtype)
    params = state_from_numpy(np_state, "cpu").params
    b = ref_batch_for_cell(ref_get_cell("xdeepfm", "serve_bulk", reduced=True), seed)
    ids = jnp.asarray(b["sparse_ids"])
    emb = ref_lookup_fields(ref_state.params["tables"], ids, NO_SHARDING).astype(
        ref_cfg.compute_dtype)
    want = np.asarray(ref_xdeepfm.cin(emb, ref_state.params["dense"]["cin"], NO_SHARDING,
                                      ref_cfg.compute_dtype).astype(jnp.float32))
    got = _np(xdeepfm.cin(torch.tensor(np.asarray(emb.astype(jnp.float32))),
                          params["dense"]["cin"], cfg.compute_dtype).float())
    assert got.shape == (b["sparse_ids"].shape[0], 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=cin_bar * np.abs(want).max())
    want = np.asarray(ref_xdeepfm._logits(ref_state.params, ids, ref_cfg, NO_SHARDING))
    got = _np(xdeepfm._logits(params, torch.from_numpy(b["sparse_ids"]), cfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=logit_bar * np.abs(want).max())
    want = np.asarray(ref_xdeepfm.serve(ref_state.params, b, ref_cfg))
    got = _np(xdeepfm.serve(params, batch_to_device(b, "cpu"), cfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=prob_bar)
    r = ref_batch_for_cell(ref_get_cell("xdeepfm", "retrieval_cand", reduced=True), seed)
    want = np.asarray(ref_xdeepfm.serve_retrieval(ref_state.params, r, ref_cfg))
    got = _np(xdeepfm.serve_retrieval(params, batch_to_device(r, "cpu"), cfg))
    assert got.shape == want.shape == (512,)
    np.testing.assert_allclose(got, want, rtol=0, atol=prob_bar)
    t = ref_batch_for_cell(ref_bundle, seed)
    ref_loss, ref_aux = ref_xdeepfm.train_loss(ref_state.params, t, ref_cfg)
    loss, aux = xdeepfm.train_loss(params, batch_to_device(t, "cpu"), cfg)
    assert abs(float(ref_loss) - float(loss)) <= loss_bar * abs(float(ref_loss))
    assert abs(float(ref_aux["accuracy"]) - float(aux["accuracy"])) < 1e-6
    assert sorted(aux["touched"]) == sorted(ref_aux["touched"])
    for name, mask in aux["touched"].items():
        np.testing.assert_array_equal(_np(mask), np.asarray(ref_aux["touched"][name]))


def test_retrieval_drops_the_remainder_at_the_full_shape():
    """The full retrieval_cand cell scores 999,424 of its 1,000,000
    candidates in both packages: the chunk arithmetic, with no model run
    (the reference's by ``jax.eval_shape`` over the full cell's shapes)."""
    ref_bundle = ref_get_cell("xdeepfm", "retrieval_cand")
    out = jax.eval_shape(lambda p, b: ref_xdeepfm.serve_retrieval(p, b, ref_bundle.cfg),
                         ref_bundle.params_shapes(), ref_bundle.make_inputs())
    bundle = get_cell("xdeepfm", "retrieval_cand", device="cpu")
    C = bundle.make_inputs()["candidate_ids"].shape[0]
    assert C == 1_000_000
    assert out.shape == (xdeepfm.n_retrieval_scores(C),) == (999_424,)
    assert xdeepfm.n_retrieval_scores(512) == 512


def test_retrieval_over_several_chunks_matches_reference(cells):
    """20,000 candidates: two whole chunks scored (16,384), the rest
    dropped, the scores the reference's within the bf16 probability bar."""
    ref_bundle, _, ref_state, np_state = cells
    params = state_from_numpy(np_state, "cpu").params
    cfg = get_cell("xdeepfm", "retrieval_cand", reduced=True, device="cpu").cfg
    r = ref_batch_for_cell(ref_get_cell("xdeepfm", "retrieval_cand", reduced=True), 4)
    r["candidate_ids"] = np.random.default_rng(4).integers(
        0, cfg.vocab_sizes[0], 20_000).astype(np.int32)
    want = np.asarray(ref_xdeepfm.serve_retrieval(
        ref_state.params, r, ref_get_cell("xdeepfm", "retrieval_cand", reduced=True).cfg))
    got = _np(xdeepfm.serve_retrieval(params, batch_to_device(r, "cpu"), cfg))
    assert got.shape == want.shape == (16_384,)
    np.testing.assert_allclose(got, want, rtol=0, atol=BARS["bfloat16"][2])


def test_train_steps_match_reference(cells):
    _check_train_steps(*cells, ref_xdeepfm.train_loss, xdeepfm.train_loss)


@pytest.mark.parametrize("quant_key", sorted(QUANTS))
def test_chunks_byte_identical(cells, quant_key):
    ref_bundle, bundle, ref_state, _ = cells
    _check_chunks(_snapshot_pair(ref_bundle, bundle, ref_state), quant_key)


@pytest.mark.parametrize("quant_key", sorted(QUANTS))
def test_restore_across_packages(cells, quant_key):
    ref_bundle, bundle, ref_state, _ = cells
    _check_cross_restore(_snapshot_pair(ref_bundle, bundle, ref_state), quant_key,
                         ["params['cin'][0]", "params['cin'][1]", "params['cin_out']",
                          "params['bias']"])


def test_dim1_tables_restore_as_their_fp16_values(cells):
    """At 4-bit adaptive (the smoke's saves) each ``lin_*`` value restores
    as its fp16 rounding, in both packages, from either package's store;
    the ``emb_*`` tables within the 4-bit bar."""
    ref_bundle, bundle, ref_state, _ = cells
    snaps = _snapshot_pair(ref_bundle, bundle, ref_state)
    for store in _save_both(snaps, "a4"):
        for rs in _restores(store):
            for i in range(39):
                live = snaps[1].tables[f"lin_{i}"]
                np.testing.assert_array_equal(
                    rs.tables[f"lin_{i}"], live.astype(np.float16).astype(np.float32))
                live = snaps[1].tables[f"emb_{i}"]
                err = np.abs(rs.tables[f"emb_{i}"] - live).mean() / np.abs(live).mean()
                assert err < 0.1, (i, err)


def test_port_trainer_saves_both_families(tmp_path):
    """The port's Trainer at 4-bit adaptive on the CPU: the full save holds
    one chunk a table of each family, and a restore gives every ``lin_*``
    value's fp16 rounding of the live table."""
    bundle = get_cell("xdeepfm", "train_batch", reduced=True, device="cpu")
    from repro_torch.core import LocalFSStore
    from repro_torch.core import manifest as mf
    from repro_torch.train.loop import Trainer, TrainerConfig

    cfg = CheckpointConfig(interval_batches=2, quant=PAPER_DEFAULTS[4], device="cpu")
    tr = Trainer(bundle, LocalFSStore(str(tmp_path)), cfg, TrainerConfig(total_steps=2))
    assert tr.init_or_restore() == 0
    tr.run(2)
    tr.manager.wait()
    live = {k: _np(v) for k, v in tr.state.params["tables"].items()}
    tr.close()
    man = mf.load(LocalFSStore(str(tmp_path)), 2)
    assert man.kind == "full" and sum(len(t.chunks) for t in man.tables.values()) == 78
    mgr = CheckNRunManager(LocalFSStore(str(tmp_path)), CheckpointConfig(device="cpu"))
    rs = mgr.restore()
    mgr.close()
    for i in range(39):
        np.testing.assert_array_equal(rs.tables[f"lin_{i}"],
                                      live[f"lin_{i}"].astype(np.float16).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
def test_cell_smoke(shape):
    out = _check_cell_smoke("xdeepfm", shape)
    if shape == "retrieval_cand":
        assert out.shape == (512,)
    elif out is not None:
        B = get_cell("xdeepfm", shape, reduced=True, device="cpu").make_inputs()[
            "sparse_ids"].shape[0]
        assert out.shape == (B,) and bool(((out >= 0) & (out <= 1)).all())


def test_launchers_train_and_serve_xdeepfm_on_cpu(tmp_path, capsys):
    from repro_torch.launch import serve, train

    assert train.main(["--arch", "xdeepfm", "--shape", "train_batch", "--steps", "4",
                       "--interval", "2", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path)]) == 0
    assert "checkpoint bytes written" in capsys.readouterr().out
    assert serve.main(["--arch", "xdeepfm", "--ckpt-dir", str(tmp_path),
                       "--requests", "48", "--batch", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "from checkpoint step 4" in out and "host probabilities out" in out


def test_xdeepfm_takes_no_vocab_cap():
    with pytest.raises(ValueError, match="no vocab cap"):
        get_cell("xdeepfm", "serve_p99", reduced=True, device="cpu", vocab_cap=512)
