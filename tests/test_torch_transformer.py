"""The port's dense LM slice (``repro_torch.models.transformer``, the LM
cells of qwen2-0.5b and nemotron-4-15b) against the reference, on their
reduced configs (2 layers, d 64, vocab 512).

Both sides start from the same numbers: the reference's initial TrainState
carried into the port through ``state_from_numpy``, the same numpy batches.
Bars:
  * the layers (``rmsnorm``, the four activations, RoPE,
    ``decode_attention``) at rtol/atol 1e-6 in f32;
  * in f32, ``forward``, ``train_loss`` and its gradients, prefill and
    decode logits at rtol/atol 1e-4 (sums in another order: GEMM blocking,
    the chunked cross-entropy's logsumexp);
  * in bf16 (the published compute dtype) the hidden states and logits at
    3e-2 of their scale (two layers of bf16 GEMMs);
  * decode against one full forward over the same tokens, in f32, at the
    reference test's bars: 2e-4 for the prefill logits, 2e-3 for each
    decode step (``tests/test_decode_equivalence.py``).
Checkpoints: the ``tok_emb`` table saved by both packages gives
byte-identical chunk objects at ``quant=None`` and 4-bit uniform_asym, and
each package restores the other's store.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import _families as ref_fam
from repro.configs import _module as ref_module
from repro.configs import get_cell as ref_get_cell
from repro.data.cells import batch_for_cell as ref_batch_for_cell
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tf
from repro_torch.configs import _families as fam
from repro_torch.configs import _module, get_cell
from repro_torch.data.cells import batch_for_cell
from repro_torch.models import layers, transformer as tf
from repro_torch.models.layers import chunked_attention
from repro_torch.train.loop import batch_to_device
from repro_torch.train.state import state_from_numpy
from test_torch_mind import (_check_batches, _check_chunks, _check_cross_restore,
                             _check_tree_and_snapshot, _np, _snapshot_pair, _to_numpy)

ARCHS = ["qwen2-0.5b", "nemotron-4-15b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
RNG = np.random.default_rng(0)


def _cells(arch, shape="train_4k", seed=0):
    ref_bundle = ref_get_cell(arch, shape, reduced=True)
    bundle = get_cell(arch, shape, reduced=True, device="cpu")
    ref_state = ref_bundle.make_state(jax.random.key(seed))
    return ref_bundle, bundle, ref_state, _to_numpy(ref_state)


def _cfgs(arch, dtype):
    return (dataclasses.replace(ref_module(arch).make_config(reduced=True),
                                compute_dtype=getattr(jnp, dtype)),
            dataclasses.replace(_module(arch).make_config(reduced=True),
                                compute_dtype=getattr(torch, dtype)))


def _close(got, want, dtype, bar=1e-4):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=bar, atol=bar)
    else:
        scale = max(float(np.abs(want).max()), 1e-3)
        assert float(np.abs(got - want).max()) <= 3e-2 * scale


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ----------------------------------------------------------------- layers


def test_rmsnorm_and_activations_match_reference():
    x = RNG.normal(size=(4, 7, 32)).astype(np.float32) * 3
    g = RNG.normal(size=(32,)).astype(np.float32)
    np.testing.assert_allclose(_np(layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(g))),
                               np.asarray(ref_layers.rmsnorm(jnp.asarray(x), jnp.asarray(g))),
                               rtol=1e-6, atol=1e-6)
    for name in ("relu", "gelu", "silu", "relu2"):
        np.testing.assert_allclose(_np(layers.act_fn(name)(torch.from_numpy(x))),
                                   np.asarray(ref_layers.act_fn(name)(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("D", [8, 16, 64, 128])
def test_rope_matches_reference(D):
    x = RNG.normal(size=(2, 9, 3, D)).astype(np.float32)
    pos = np.arange(9)[None, :] + 1000
    np.testing.assert_array_equal(_np(layers.rope_freqs(D)), np.asarray(ref_layers.rope_freqs(D)))
    np.testing.assert_allclose(
        _np(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))),
        np.asarray(ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos))),
        rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("cache_len", [1, 13, 40])
def test_decode_attention_matches_reference(cache_len):
    q = RNG.normal(size=(2, 1, 6, 16)).astype(np.float32)
    k, v = (RNG.normal(size=(2, 40, 2, 16)).astype(np.float32) for _ in range(2))
    want = ref_layers.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.int32(cache_len))
    got = layers.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), cache_len)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- model


@pytest.mark.parametrize("arch", ARCHS)
def test_params_tree_and_snapshot_keys_match(arch):
    snap = _check_tree_and_snapshot(*_cells(arch))
    assert list(snap.tables) == ["tok_emb"]
    assert "params['blocks']['attn']['wq']" in snap.dense
    assert ("params['blocks']['attn']['bq']" in snap.dense) == (arch == "qwen2-0.5b")
    assert ("params['blocks']['ffn']['wg']" in snap.dense) == (arch == "qwen2-0.5b")


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_identical(arch):
    for shape in ("train_4k", "prefill_32k"):
        _check_batches(arch, shape)
    ref_b = ref_batch_for_cell(ref_get_cell(arch, "decode_32k", reduced=True), 1)
    b = get_cell(arch, "decode_32k", reduced=True, device="cpu")
    got = batch_for_cell(b, 1)
    np.testing.assert_array_equal(got["tokens"], ref_b["tokens"])
    assert int(got["cache_len"]) == int(ref_b["cache_len"])
    for k in ("k", "v"):
        assert tuple(got["cache"][k].shape) == ref_b["cache"][k].shape
        assert got["cache"][k].dtype == torch.bfloat16 and not got["cache"][k].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch, dtype):
    ref_bundle, bundle, ref_state, np_state = _cells(arch)
    ref_cfg, cfg = _cfgs(arch, dtype)
    params = state_from_numpy(np_state, "cpu").params
    b = ref_batch_for_cell(ref_bundle, 1)
    tb = batch_to_device(b, "cpu")
    h_ref, _, _, _ = ref_tf.forward(ref_state.params, jnp.asarray(b["tokens"]), ref_cfg)
    with torch.no_grad():
        h, _ = tf.forward(params, tb["tokens"], cfg)
    _close(_np(h.float()), _f32(h_ref), dtype)
    ref_loss, ref_aux = ref_tf.train_loss(ref_state.params, b, ref_cfg)
    loss, aux = tf.train_loss(params, tb, cfg)
    _close(np.float32(float(loss)), np.float32(float(ref_loss)), dtype)
    np.testing.assert_array_equal(_np(aux["touched"]["tok_emb"]),
                                  np.asarray(ref_aux["touched"]["tok_emb"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    """``train_loss``'s gradients in f32, every leaf (layers recomputed
    in the backward, the cross-entropy chunk by chunk)."""
    ref_bundle, bundle, ref_state, np_state = _cells(arch)
    ref_cfg, cfg = _cfgs(arch, "float32")
    b = ref_batch_for_cell(ref_bundle, 2)
    ref_g = jax.grad(lambda p: ref_tf.train_loss(p, b, ref_cfg)[0])(ref_state.params)
    params = state_from_numpy(np_state, "cpu").params
    leaves = [t.requires_grad_(True) for t in jax.tree_util.tree_leaves(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    loss, _ = tf.train_loss(params, batch_to_device(b, "cpu"), cfg)
    grads = torch.autograd.grad(loss, leaves)
    ref_leaves = jax.tree_util.tree_leaves(ref_g)
    assert len(ref_leaves) == len(grads)
    for a, g in zip(ref_leaves, grads):
        a = np.asarray(a)
        np.testing.assert_allclose(_np(g), a, rtol=1e-3,
                                   atol=1e-4 * max(float(np.abs(a).max()), 1e-6))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_reference(arch, dtype):
    """``prefill_step`` through both attentions (the flash op's plain
    version, as the CPU runs it, and ``chunked_attention``) and one
    ``decode_step`` against a cache, against the reference's."""
    ref_bundle, bundle, ref_state, np_state = _cells(arch, "prefill_32k")
    ref_cfg, cfg = _cfgs(arch, dtype)
    params = state_from_numpy(np_state, "cpu").params
    tokens = ref_batch_for_cell(ref_bundle, 0)["tokens"]
    ref_logits, ref_caches = ref_tf.prefill_step(ref_state.params, jnp.asarray(tokens), ref_cfg)
    for attention in (tf.flash_attention, chunked_attention):
        logits, caches = tf.prefill_step(params, torch.from_numpy(tokens), cfg,
                                         attention=attention)
        assert logits.shape == ref_logits.shape
        _close(_np(logits), np.asarray(ref_logits), dtype)
        for k in ("k", "v"):
            assert tuple(caches[k].shape) == ref_caches[k].shape
            _close(_np(caches[k].float()), _f32(ref_caches[k]), dtype)
    B, S = tokens.shape
    ref_c = {k: jnp.zeros((c.shape[0], B, S + 4) + c.shape[3:], c.dtype).at[:, :, :S].set(c)
             for k, c in ref_caches.items()}
    c = {k: torch.zeros((v.shape[0], B, S + 4) + tuple(v.shape[3:]), dtype=v.dtype)
         for k, v in caches.items()}
    for k in c:
        c[k][:, :, :S] = caches[k]
    nxt = RNG.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    want, ref_c = ref_tf.decode_step(ref_state.params, jnp.asarray(nxt), ref_c,
                                     jnp.int32(S), ref_cfg)
    got, c2 = tf.decode_step(params, torch.from_numpy(nxt), c, S, cfg)
    assert c2 is c  # written in place
    _close(_np(got), np.asarray(want), dtype)
    for k in c:
        _close(_np(c[k].float()), _f32(ref_c[k]), dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """``tests/test_decode_equivalence.py`` on the port: prefill a prompt,
    decode greedily token by token, and compare every step against one full
    forward over the final sequence, in f32."""
    _, cfg = _cfgs(arch, "float32")
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    B, prompt_len, n_decode, max_len = 2, 7, 4, 16
    prompt = torch.from_numpy(RNG.integers(1, cfg.vocab, (B, prompt_len)).astype(np.int32))
    logits_p, caches = tf.prefill_step(params, prompt, cfg)
    full = tf.init_cache(cfg, B, max_len, torch.float32)
    for k in full:
        full[k][:, :, :prompt_len] = caches[k]
    seq, step_logits = prompt, [logits_p[:, -1]]
    nxt = torch.argmax(logits_p[:, -1], dim=-1).to(torch.int32)[:, None]
    for i in range(n_decode):
        seq = torch.cat([seq, nxt], dim=1)
        logits_d, full = tf.decode_step(params, nxt, full, prompt_len + i, cfg)
        step_logits.append(logits_d[:, -1])
        nxt = torch.argmax(logits_d[:, -1], dim=-1).to(torch.int32)[:, None]
    with torch.no_grad():
        ref = tf.logits_fn(params, tf.forward(params, seq, cfg)[0], cfg)
    np.testing.assert_allclose(_np(step_logits[0]), _np(ref[:, prompt_len - 1]),
                               rtol=2e-4, atol=2e-4)
    for i in range(1, n_decode + 1):
        np.testing.assert_allclose(_np(step_logits[i]), _np(ref[:, prompt_len - 1 + i]),
                                   rtol=2e-3, atol=2e-3, err_msg=f"decode step {i - 1}")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    for reduced in (False, True):
        want = ref_module(arch).make_config(reduced=reduced)
        got = _module(arch).make_config(reduced=reduced)
        assert got.param_count == want.param_count
        assert got.active_param_count == want.active_param_count


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_full_cell_specs_and_flops_match_reference(arch, shape):
    ref_bundle = ref_get_cell(arch, shape)
    bundle = get_cell(arch, shape, device="cpu")
    flat = lambda d, f: {k: f(v) for k, v in d.items() if not isinstance(v, dict)}
    want = ref_bundle.make_inputs()
    got = bundle.make_inputs()
    assert sorted(got) == sorted(want)
    sd = lambda v: (tuple(v.shape), np.dtype(v.dtype).name if not isinstance(
        v.dtype, torch.dtype) else str(v.dtype).split(".")[-1])
    assert flat(got, sd) == flat(want, sd)
    if "cache" in want:
        for k in ("k", "v"):
            assert sd(got["cache"][k]) == sd(want["cache"][k])
    assert bundle.model_flops == ref_bundle.model_flops
    for path in ("['tables']['tok_emb']", "['dense']['blocks']['attn']['wq']",
                 "['dense']['blocks']['ffn']['w2']", "['dense']['w_out']"):
        shp = (3, 4, 5, 6) if "wq" in path else (4, 5)
        assert fam.lm_param_axes(path, shp) == ref_fam.lm_param_axes(path, shp)


def test_moe_and_mla_configs_raise():
    for arch in ("olmoe-1b-7b", "minicpm3-4b"):
        ref_cfg = ref_module(arch).make_config(reduced=True)
        cfg = tf.TransformerConfig(**{f.name: getattr(ref_cfg, f.name)
                                      for f in dataclasses.fields(tf.TransformerConfig)
                                      if f.name != "compute_dtype"})
        with pytest.raises(NotImplementedError, match="A6.4"):
            tf.init_params(torch.Generator(), cfg)


@pytest.mark.parametrize("quant_key", ["none", "u4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tok_emb_chunks_byte_identical(arch, quant_key):
    ref_bundle, bundle, ref_state, _ = _cells(arch)
    _check_chunks(_snapshot_pair(ref_bundle, bundle, ref_state), quant_key)


@pytest.mark.parametrize("quant_key", ["none", "u4"])
def test_restore_across_packages(quant_key):
    ref_bundle, bundle, ref_state, _ = _cells("qwen2-0.5b")
    _check_cross_restore(_snapshot_pair(ref_bundle, bundle, ref_state), quant_key,
                         ["params['blocks']['attn']['bq']", "params['w_out']"])


def test_launcher_trains_qwen2_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    assert train.main(["--arch", "qwen2-0.5b", "--shape", "train_4k", "--steps", "2",
                       "--interval", "2", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path)]) == 0
    assert "checkpoint bytes written" in capsys.readouterr().out
