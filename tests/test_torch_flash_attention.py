"""The port's flash-attention plain version (what the wrapper runs on the
CPU) against the reference's Pallas kernel in interpret mode and its
jnp oracle, on the same numpy inputs.

Tolerances are the reference's own (``tests/test_kernels.py:58-84``): f32
within 2e-3 (the sums run in another order; the measured gap is ~1e-6),
bf16 within 3e-2 (outputs rounded to bf16 may land on neighbouring values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as ref_oracle
from repro_torch.kernels.flash_attention import (
    MMA_LAUNCHES,
    SIMT_LAUNCHES,
    flash_attention,
    flash_attention_cuda,
    flash_attention_torch,
)
from repro_torch.models.layers import chunked_attention

SHAPES = [
    (2, 128, 4, 2, 64, True),
    (1, 256, 8, 8, 32, False),
    (2, 128, 2, 1, 100, True),
    (1, 192, 4, 4, 64, True),
    (2, 200, 2, 2, 32, False),   # the bert4rec serve shape
]


def _qkv(B, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, h, D)).astype(np.float32) for h in (Hq, Hkv, Hkv)]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", SHAPES)
def test_plain_matches_reference_kernel_and_oracle(B, S, Hq, Hkv, D, causal):
    q, k, v = _qkv(B, S, Hq, Hkv, D, seed=S + D)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal).numpy()
    blk = 64 if S % 64 == 0 else S
    want = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, impl="interpret",
                                block_q=blk, block_k=blk))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    oracle = np.asarray(ref_oracle(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=causal))
    np.testing.assert_allclose(got, oracle, rtol=2e-3, atol=2e-3)


def test_plain_bf16_matches_reference():
    rng = np.random.default_rng(42)
    q, k, v = (rng.normal(size=(1, 128, h, 64)).astype(np.float32) for h in (4, 2, 2))
    tq = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = flash_attention(*tq, causal=True)
    assert got.dtype == torch.bfloat16
    jq = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want = ref_flash(*jq, causal=True, impl="interpret", block_q=64, block_k=64)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_the_models_chunked_attention(causal):
    """The kernel's plain version and the training path's attention compute
    the same function; chunked here into 3 q and 2 k chunks with padding."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 200, 4, 2, 32, seed=7))
    want = chunked_attention(q, k, v, causal=causal, q_chunk=72, k_chunk=128)
    got = flash_attention_torch(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_plain_runs_large_batches_in_slices(monkeypatch):
    from repro_torch.kernels.flash_attention import ref

    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 16, 2, 1, 8, seed=3))
    whole = flash_attention_torch(q, k, v, causal=False)
    monkeypatch.setattr(ref, "MAX_SCORES", 2 * 16 * 16 * 2)  # two rows a slice
    torch.testing.assert_close(flash_attention_torch(q, k, v, causal=False), whole,
                               rtol=0, atol=0)


def test_cpu_tensors_never_reach_the_kernel():
    """On the CPU the wrapper takes the plain path and counts no launch; the
    kernel entry refuses a CPU tensor instead of falling back."""
    before = (MMA_LAUNCHES.count, SIMT_LAUNCHES.count)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((1, 8, 2, 32), dtype=dtype)
        flash_attention(q, q, q, causal=False)
        assert (MMA_LAUNCHES.count, SIMT_LAUNCHES.count) == before
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention_cuda(q, q, q, causal=False)


def _tensor_core_roundings(q, k, v, causal):
    """The bf16 tensor-core kernel's arithmetic, written out in torch: bf16
    q, k, v; f32 scores (bf16 products are exact in f32); a running max of
    the raw scores and exp2 of one fused step, s * (scale * log2 e) -
    m * (scale * log2 e), per 64-key step; p split into its top half (p cut
    to bf16) and the bf16 rounding of the remainder, each multiplied into v
    in f32; f32 sums of p and f32 accumulation; the divide by
    max(l, 1e-30) (the kernel multiplies by its reciprocal, within an f32
    ulp); the output rounded to bf16."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    c = np.float32(np.float32(1.0 / np.sqrt(D)) * np.float32(np.log2(np.e)))
    f = lambda t: t.to(torch.bfloat16).to(torch.float32)
    qf = f(q).reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4)   # (B, Hkv, G, Sq, D)
    kf, vf = (f(t).permute(0, 2, 1, 3)[:, :, None] for t in (k, v))  # (B, Hkv, 1, Sk, D)
    neg = float(np.finfo(np.float32).min)
    m = torch.full((B, Hkv, G, Sq, 1), neg)
    l = torch.zeros((B, Hkv, G, Sq, 1))
    acc = torch.zeros((B, Hkv, G, Sq, D))
    for k0 in range(0, Sk, 64):
        s = qf @ kf[..., k0:k0 + 64, :].transpose(-1, -2)
        if causal:
            keep = (torch.arange(Sq)[:, None] >= torch.arange(k0, min(Sk, k0 + 64))[None])
            s = torch.where(keep, s, neg)
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2((m - mx) * c)
        p = torch.exp2(torch.addcmul(-(mx * c), s, torch.tensor(c)))
        l = l * corr + p.sum(-1, keepdim=True)
        hi = (p.view(torch.int32) & -65536).view(torch.float32)  # p cut to bf16
        acc = acc * corr + hi @ vf[..., k0:k0 + 64, :] + f(p - hi) @ vf[..., k0:k0 + 64, :]
        m = mx
    o = acc / torch.clamp(l, min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(torch.bfloat16)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", [(2, 200, 2, 2, 32, False),
                                                  (2, 192, 4, 1, 64, True)])
def test_tensor_core_roundings_within_the_bf16_bar(B, S, Hq, Hkv, D, causal):
    """The rounding budget of the bf16 tensor-core kernel, on the CPU: its
    roundings, repeated in torch, stay within the bf16 bar (3e-2) of the
    reference's Pallas kernel in interpret mode, at the bert4rec serve shape
    and at a GQA causal shape."""
    q, k, v = _qkv(B, S, Hq, Hkv, D, seed=S + Hq + D)
    tq = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = _tensor_core_roundings(*tq, causal=causal).to(torch.float32).numpy()
    jq = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    blk = 64 if S % 64 == 0 else S
    want = np.asarray(ref_flash(*jq, causal=causal, impl="interpret",
                                block_q=blk, block_k=blk), dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)
    # and the plain version (what the card's kernel is checked against)
    plain = flash_attention_torch(*tq, causal=causal).to(torch.float32).numpy()
    np.testing.assert_allclose(got, plain, rtol=3e-2, atol=3e-2)
