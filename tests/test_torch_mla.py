"""The port's Multi-head Latent Attention (``repro_torch.models.layers
.mla_attention``, minicpm3-4b through ``models.transformer``) against the
reference, on reduced configs, and decode against a full forward for
minicpm3-4b and olmoe-1b-7b in both packages.

Bars, as the transformer tests': in f32 the layer's outputs and caches at
rtol/atol 1e-5 (einsums summed in another order), the model's forward,
loss, prefill and decode at 1e-4, gradients at rtol 1e-3; in bf16 the
hidden states and logits within 3e-2 of their scale. Decode against one
full forward over the same tokens at ``tests/test_decode_equivalence.py``'s
bars: 2e-4 for the prefill logits, 2e-3 for each decode step. Prefill
takes both attentions: ``chunked_attention`` and the flash op's plain
version (what the CPU runs; on the card the kernel, v padded from its head
dim to the qk head dim).
"""

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
from repro_torch.configs import get_cell
from repro_torch.data.cells import batch_for_cell
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers, transformer as tf
from repro_torch.models.layers import chunked_attention
from repro_torch.train.loop import batch_to_device
from repro_torch.train.state import state_from_numpy
from repro_torch.tree import flatten_with_path, keystr
from test_torch_mind import _check_tree_and_snapshot, _np
from test_torch_moe import MARGIN, _router_margins
from test_torch_transformer import _cells, _cfgs, _close, _f32

ARCH = "minicpm3-4b"


def _mla_inputs(seed=0, B=2, S=9):
    ref_cfg = ref_module(ARCH).make_config(reduced=True)
    ref_p = ref_layers.mla_params_init(jax.random.key(seed), ref_cfg.d_model,
                                       ref_cfg.n_heads, ref_cfg.mla)
    p = {k: torch.from_numpy(np.array(v)) for k, v in ref_p.items()}
    x = np.random.default_rng(seed + 1).normal(size=(B, S, ref_cfg.d_model)).astype(np.float32)
    return ref_cfg, ref_p, p, x


@pytest.mark.parametrize("attention", [chunked_attention, flash_attention],
                         ids=["chunked", "flash"])
def test_mla_prefill_matches_reference(attention):
    ref_cfg, ref_p, p, x = _mla_inputs()
    pos = np.arange(x.shape[1])[None, :]
    m = layers.MLAConfig(**dataclasses.asdict(ref_cfg.mla))
    want, want_c = ref_layers.mla_attention(jnp.asarray(x), ref_p, ref_cfg.mla,
                                            ref_cfg.n_heads, jnp.asarray(pos),
                                            compute_dtype=jnp.float32)
    got, got_c = layers.mla_attention(torch.from_numpy(x), p, m, ref_cfg.n_heads,
                                      torch.from_numpy(pos), compute_dtype=torch.float32,
                                      attention=attention)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    for k in ("ckv", "kpe"):
        np.testing.assert_allclose(_np(got_c[k]), np.asarray(want_c[k]), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_absorbed_decode_matches_reference(dtype):
    """Two new tokens against a latent cache that holds 9 of 16 positions:
    written in place at ``cache_len``, scores and values against the
    latents."""
    ref_cfg, ref_p, p, x = _mla_inputs(seed=3, S=2)
    m = layers.MLAConfig(**dataclasses.asdict(ref_cfg.mla))
    rng = np.random.default_rng(4)
    B, S, L0, Smax = 2, 2, 9, 16
    ckv = np.zeros((B, Smax, m.kv_lora_rank), np.float32)
    kpe = np.zeros((B, Smax, m.qk_rope_dim), np.float32)
    ckv[:, :L0] = rng.normal(size=(B, L0, m.kv_lora_rank))
    kpe[:, :L0] = rng.normal(size=(B, L0, m.qk_rope_dim))
    pos = L0 + np.arange(S)[None, :]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref_cache = dict(ckv=jnp.asarray(ckv).astype(jd), kpe=jnp.asarray(kpe).astype(jd))
    cache = dict(ckv=torch.from_numpy(ckv).to(td), kpe=torch.from_numpy(kpe).to(td))
    want, want_c = ref_layers.mla_attention(jnp.asarray(x), ref_p, ref_cfg.mla,
                                            ref_cfg.n_heads, jnp.asarray(pos),
                                            compute_dtype=jd, cache=ref_cache,
                                            cache_len=jnp.int32(L0))
    got, got_c = layers.mla_attention(torch.from_numpy(x), p, m, ref_cfg.n_heads,
                                      torch.from_numpy(pos), compute_dtype=td,
                                      cache=cache, cache_len=L0)
    assert got_c is cache  # written in place
    bar = 1e-5 if dtype == "float32" else 3e-2
    _close(_np(got), np.asarray(want), dtype, bar)
    for k in ("ckv", "kpe"):
        _close(_np(cache[k].float()), _f32(want_c[k]), dtype, bar)


def test_v_pad_to_matches_reference():
    v = np.random.default_rng(5).normal(size=(2, 3, 4, 16)).astype(np.float32)
    np.testing.assert_array_equal(_np(layers.v_pad_to(torch.from_numpy(v), 24)),
                                  np.asarray(ref_layers.v_pad_to(jnp.asarray(v), 24)))
    assert layers.v_pad_to(torch.from_numpy(v), 16).shape == v.shape


# ------------------------------------------------------------------ model


def test_params_tree_and_snapshot_keys_match():
    snap = _check_tree_and_snapshot(*_cells(ARCH))
    assert list(snap.tables) == ["tok_emb"]
    assert "params['blocks']['mla']['w_uk']" in snap.dense
    assert "params['blocks']['attn']['wq']" not in snap.dense


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_match_reference(dtype):
    ref_bundle, bundle, ref_state, np_state = _cells(ARCH)
    ref_cfg, cfg = _cfgs(ARCH, dtype)
    params = state_from_numpy(np_state, "cpu").params
    b = ref_batch_for_cell(ref_bundle, 1)
    tb = batch_to_device(b, "cpu")
    h_ref, _, _, _ = ref_tf.forward(ref_state.params, jnp.asarray(b["tokens"]), ref_cfg)
    with torch.no_grad():
        h, _, touched, aux = tf.forward(params, tb["tokens"], cfg)
    assert touched is None and float(aux) == 0.0
    _close(_np(h.float()), _f32(h_ref), dtype)
    ref_loss, _ = ref_tf.train_loss(ref_state.params, b, ref_cfg)
    loss, out = tf.train_loss(params, tb, cfg)
    _close(np.float32(float(loss)), np.float32(float(ref_loss)), dtype)
    assert list(out["touched"]) == ["tok_emb"]


def test_gradients_match_reference():
    ref_bundle, bundle, ref_state, np_state = _cells(ARCH)
    ref_cfg, cfg = _cfgs(ARCH, "float32")
    b = ref_batch_for_cell(ref_bundle, 2)
    ref_g = jax.grad(lambda p: ref_tf.train_loss(p, b, ref_cfg)[0])(ref_state.params)
    params = state_from_numpy(np_state, "cpu").params
    leaves = [t.requires_grad_(True) for _, t in flatten_with_path(params)]
    loss, _ = tf.train_loss(params, batch_to_device(b, "cpu"), cfg)
    grads = torch.autograd.grad(loss, leaves)
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_g)[0]
    assert [jax.tree_util.keystr(p) for p, _ in ref_leaves] == [
        keystr(p) for p, _ in flatten_with_path(params)]
    for (path, a), g in zip(ref_leaves, grads):
        a = np.asarray(a)
        np.testing.assert_allclose(_np(g), a, rtol=1e-3,
                                   atol=1e-4 * max(float(np.abs(a).max()), 1e-6),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_steps_match_reference(dtype):
    ref_bundle, bundle, ref_state, np_state = _cells(ARCH, "prefill_32k")
    ref_cfg, cfg = _cfgs(ARCH, dtype)
    params = state_from_numpy(np_state, "cpu").params
    tokens = ref_batch_for_cell(ref_bundle, 0)["tokens"]
    ref_logits, ref_caches = ref_tf.prefill_step(ref_state.params, jnp.asarray(tokens), ref_cfg)
    for attention in (tf.flash_attention, chunked_attention):
        logits, caches = tf.prefill_step(params, torch.from_numpy(tokens), cfg,
                                         attention=attention)
        _close(_np(logits), np.asarray(ref_logits), dtype)
        for k in ("ckv", "kpe"):
            assert tuple(caches[k].shape) == ref_caches[k].shape
            _close(_np(caches[k].float()), _f32(ref_caches[k]), dtype)
    B, S = tokens.shape
    ref_c = {k: jnp.zeros((c.shape[0], B, S + 4) + c.shape[3:], c.dtype).at[:, :, :S].set(c)
             for k, c in ref_caches.items()}
    c = tf.init_cache(cfg, B, S + 4, caches["ckv"].dtype)
    for k in c:
        c[k][:, :, :S] = caches[k]
    nxt = np.random.default_rng(6).integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    want, ref_c = ref_tf.decode_step(ref_state.params, jnp.asarray(nxt), ref_c,
                                     jnp.int32(S), ref_cfg)
    got, c2 = tf.decode_step(params, torch.from_numpy(nxt), c, S, cfg)
    assert c2 is c
    _close(_np(got), np.asarray(want), dtype)
    for k in c:
        _close(_np(c[k].float()), _f32(ref_c[k]), dtype)


def test_decode_cell_inputs_are_the_latent_cache():
    from repro.configs import get_cell as ref_get_cell

    for reduced in (True, False):
        for shape in ("decode_32k", "long_500k"):
            ref_b = ref_get_cell(ARCH, shape, reduced=reduced)
            b = get_cell(ARCH, shape, reduced=reduced, device="cpu")
            want, got = ref_b.make_inputs()["cache"], b.make_inputs()["cache"]
            assert sorted(got) == sorted(want) == ["ckv", "kpe"]
            for k in got:
                assert tuple(got[k].shape) == tuple(want[k].shape)
            assert b.model_flops == ref_b.model_flops
    batch = batch_for_cell(get_cell(ARCH, "long_500k", reduced=True, device="cpu"), 0)
    assert tuple(batch["cache"]["ckv"].shape) == (2, 1, 256, 16)
    assert int(batch["cache_len"]) == 128


# --------------------------------------- tests/test_decode_equivalence.py


@pytest.mark.parametrize("arch", ["minicpm3-4b", "olmoe-1b-7b"])
def test_decode_matches_full_forward(arch, monkeypatch):
    """Prefill a prompt, decode greedily token by token, and compare every
    step against one full forward over the final sequence, in f32, in both
    packages from the same parameters: the port's decode against the
    port's forward and against the reference's over the same tokens, and
    the reference's own decode against its forward over them."""
    ref_cfg, cfg = _cfgs(arch, "float32")
    ref_params = ref_tf.init_params(jax.random.key(0), ref_cfg)
    params = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), ref_params)
    rng = np.random.default_rng(0)
    B, prompt_len, n_decode, max_len = 2, 7, 4, 16
    prompt = rng.integers(1, cfg.vocab, (B, prompt_len)).astype(np.int32)
    margins = []
    with _router_margins(monkeypatch, margins):
        logits_p, caches = tf.prefill_step(params, torch.from_numpy(prompt), cfg)
        full = tf.init_cache(cfg, B, max_len, torch.float32)
        for k in full:
            full[k][:, :, :prompt_len] = caches[k]
        seq, step_logits = torch.from_numpy(prompt), [logits_p[:, -1]]
        nxt = torch.argmax(logits_p[:, -1], dim=-1).to(torch.int32)[:, None]
        for i in range(n_decode):
            seq = torch.cat([seq, nxt], dim=1)
            logits_d, full = tf.decode_step(params, nxt, full, prompt_len + i, cfg)
            step_logits.append(logits_d[:, -1])
            nxt = torch.argmax(logits_d[:, -1], dim=-1).to(torch.int32)[:, None]
        with torch.no_grad():
            ref = tf.logits_fn(params, tf.forward(params, seq, cfg)[0], cfg)
    assert not margins or min(margins) > MARGIN
    # the reference: its forward over the port's tokens, and its own decode
    seq_np = _np(seq)
    h_ref, _, _, _ = ref_tf.forward(ref_params, jnp.asarray(seq_np), ref_cfg)
    ref_full = np.asarray(ref_tf.logits_fn(ref_params, h_ref, ref_cfg, ref_tf.NO_SHARDING))
    ref_logits_p, ref_caches = ref_tf.prefill_step(ref_params, jnp.asarray(prompt), ref_cfg)
    ref_caches = jax.tree.map(lambda c: jnp.zeros(c.shape[:2] + (max_len,) + c.shape[3:],
                                                  c.dtype).at[:, :, :prompt_len].set(c),
                              ref_caches)
    ref_steps = [np.asarray(ref_logits_p[:, -1])]
    for i in range(n_decode):
        t = jnp.asarray(seq_np[:, prompt_len + i:prompt_len + i + 1])
        logits_d, ref_caches = ref_tf.decode_step(ref_params, t, ref_caches,
                                                  jnp.int32(prompt_len + i), ref_cfg)
        ref_steps.append(np.asarray(logits_d[:, -1]))
    for i in range(n_decode + 1):
        bar = 2e-4 if i == 0 else 2e-3
        at = prompt_len - 1 + i
        for got, want in ((_np(step_logits[i]), _np(ref[:, at])),
                          (_np(step_logits[i]), ref_full[:, at]),
                          (ref_steps[i], ref_full[:, at])):
            np.testing.assert_allclose(got, want, rtol=bar, atol=bar,
                                       err_msg=f"{arch}: step {i - 1}")


def test_launcher_trains_minicpm3_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    assert train.main(["--arch", "minicpm3-4b", "--shape", "train_4k", "--steps", "2",
                       "--interval", "2", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path)]) == 0
    assert "checkpoint bytes written" in capsys.readouterr().out
