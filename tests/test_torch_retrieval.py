"""The port's retrieval slice (the ``retrieval_cand`` cell) against the
reference, on the CPU, at the reduced shape: one user against C = 512
candidates.

* ``batch_for_cell`` gives the reference's batch array for array (the
  same ``rng`` draws in the same order; dlrm-rm2's candidates over field
  0's vocabulary).
* dlrm-rm2 ``serve_retrieval``: params from the reference's init, the same
  numpy batch; probabilities within 1e-5 in f32 compute and 1e-3 in the
  model's bf16, the serve bars of ``tests/test_torch_serving.py``. Its top
  MLP input is the reference's retrieval layout, not ``serve``'s: a test
  here shows the two scores differ when the candidate is field 0's id.
* bert4rec ``serve_retrieval`` within 1e-5 (f32, as
  ``tests/test_torch_bert4rec.py``), and equal to ``serve`` on the same
  sequence for the first 100 candidates within 1e-6: the encode is the
  same; only the last product's summation order differs.
* The plain ops passed in give the default forward bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_cell as ref_get_cell
from repro.data.cells import batch_for_cell as ref_batch_for_cell
from repro.models import bert4rec as ref_b4r
from repro.models import dlrm as ref_dlrm
from repro_torch.configs import get_cell
from repro_torch.data.cells import batch_for_cell
from repro_torch.kernels.embedding_bag import embedding_bag_fields_torch
from repro_torch.kernels.flash_attention import flash_attention_torch
from repro_torch.models import bert4rec, dlrm
from repro_torch.train.loop import batch_to_device
from repro_torch.train.state import state_from_numpy

ARCHS = ["dlrm-rm2", "bert4rec"]
C = 512


def _to_numpy(ref_state):
    tree = lambda t: jax.tree.map(lambda a: np.array(a), t)
    return dict(step=np.asarray(ref_state.step), params=tree(ref_state.params),
                opt_state=tree(ref_state.opt_state), touched=tree(ref_state.touched),
                rng=np.asarray(jax.random.key_data(ref_state.rng)))


@pytest.fixture(scope="module")
def cells():
    out = {}
    for arch in ARCHS:
        ref_bundle = ref_get_cell(arch, "retrieval_cand", reduced=True)
        bundle = get_cell(arch, "retrieval_cand", reduced=True, device="cpu")
        ref_state = ref_get_cell(arch, "train_batch", reduced=True).make_state()
        params = state_from_numpy(_to_numpy(ref_state), "cpu").params
        out[arch] = (arch, ref_bundle, bundle, ref_state.params, params)
    return out


def _cfgs(ref_bundle, bundle, compute):
    if compute == "bf16":
        return ref_bundle.cfg, bundle.cfg
    return (dataclasses.replace(ref_bundle.cfg, compute_dtype=jnp.float32),
            dataclasses.replace(bundle.cfg, compute_dtype=torch.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_inputs_and_batches_are_the_references(cells, arch):
    arch, ref_bundle, bundle, _, _ = cells[arch]
    assert bundle.kind == "retrieval"
    specs = bundle.make_inputs()
    ref_specs = ref_bundle.make_inputs()
    assert list(specs) == list(ref_specs)
    for k in specs:
        assert specs[k].shape == tuple(ref_specs[k].shape), k
    assert specs["candidate_ids"].shape == (C,)
    for i in (0, 5):
        a, b = ref_batch_for_cell(ref_bundle, i), batch_for_cell(bundle, i)
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
    if arch == "dlrm-rm2":
        assert b["candidate_ids"].max() < bundle.cfg.vocab_sizes[0]


@pytest.mark.parametrize("arch,compute", [
    ("dlrm-rm2", "f32"), ("dlrm-rm2", "bf16"),
    ("bert4rec", "f32"),   # held in f32, as tests/test_torch_bert4rec.py
])
def test_scores_match_reference(cells, arch, compute):
    arch, ref_bundle, bundle, ref_params, params = cells[arch]
    ref_cfg, cfg = _cfgs(ref_bundle, bundle, compute)
    ref_mod, mod = ((ref_dlrm, dlrm) if arch == "dlrm-rm2"
                    else (ref_b4r, bert4rec))
    batch = ref_batch_for_cell(ref_bundle, 3)
    want = np.asarray(ref_mod.serve_retrieval(ref_params, batch, ref_cfg))
    got = mod.serve_retrieval(params, batch_to_device(batch, "cpu"), cfg)
    assert got.dtype == torch.float32 and not got.requires_grad
    assert got.shape == (C,) and torch.isfinite(got).all()
    bar = 1e-3 if compute == "bf16" else 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=0 if arch == "dlrm-rm2"
                               else 1e-5, atol=bar)
    if compute == "bf16":
        # the bundle's step_fn is the same forward
        np.testing.assert_array_equal(
            bundle.step_fn(params, batch_to_device(batch, "cpu")).numpy(),
            got.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_plain_ops_give_the_same_forward(cells, arch):
    """The plain op passed in (as the card check does) is the default
    forward on CPU tensors, bit for bit."""
    arch, _, bundle, _, params = cells[arch]
    batch = batch_to_device(batch_for_cell(bundle, 1), "cpu")
    if arch == "dlrm-rm2":
        a = dlrm.serve_retrieval(params, batch, bundle.cfg)
        b = dlrm.serve_retrieval(params, batch, bundle.cfg,
                                 bag=embedding_bag_fields_torch)
    else:
        a = bert4rec.serve_retrieval(params, batch, bundle.cfg)
        b = bert4rec.serve_retrieval(params, batch, bundle.cfg,
                                     attention=flash_attention_torch)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_bert4rec_retrieval_is_serve_on_a_candidate_subset(cells):
    _, _, bundle, _, params = cells["bert4rec"]
    # a trained-looking bias, so the bias term is held too
    params = dict(params, dense=dict(params["dense"]))
    params["dense"]["out_bias"] = torch.from_numpy(
        np.random.default_rng(0).normal(
            size=params["dense"]["out_bias"].shape).astype(np.float32))
    cfg = dataclasses.replace(bundle.cfg, compute_dtype=torch.float32)
    batch = batch_to_device(batch_for_cell(bundle, 2), "cpu")
    scores = bert4rec.serve_retrieval(params, batch, cfg)
    sub = dict(items=batch["items"], candidate_ids=batch["candidate_ids"][None, :100])
    want = bert4rec.serve(params, sub, cfg)[0]
    torch.testing.assert_close(scores[:100], want, rtol=0, atol=1e-6)


def test_dlrm_retrieval_is_not_serve_with_field_0_replaced(cells):
    """The retrieval top MLP reads [bot, cand·fixedᵀ, triu(fixed·fixedᵀ)],
    not serve's [bot, triu(feats·featsᵀ)] with field 0 replaced: on a
    candidate equal to the user's own field-0 id the two scores differ."""
    _, _, bundle, _, params = cells["dlrm-rm2"]
    cfg = dataclasses.replace(bundle.cfg, compute_dtype=torch.float32)
    batch = batch_to_device(batch_for_cell(bundle, 4), "cpu")
    batch["candidate_ids"] = batch["sparse_ids"][0, 0, :1].clone()
    got = dlrm.serve_retrieval(params, batch, cfg)
    served = dlrm.serve(params, dict(sparse_ids=batch["sparse_ids"],
                                     dense=batch["dense"]), cfg)
    assert got.shape == served.shape == (1,)
    assert abs(float(got[0]) - float(served[0])) > 1e-6
