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
    LAUNCHES,
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
    q = torch.zeros((1, 8, 2, 32))
    before = LAUNCHES.count
    flash_attention(q, q, q, causal=False)
    assert LAUNCHES.count == before
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q, causal=False)
