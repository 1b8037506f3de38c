"""The port's plain chunk hash against the reference's numpy oracle and its
device implementations (jitted jnp, and the Pallas kernel in interpret
mode). A 32-bit sum is exact in any order, so every comparison is equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.chunk_hash import chunk_hash32_device as ref_hash_device
from repro.kernels.chunk_hash.ref import chunk_hash32 as ref_chunk_hash32
from repro.kernels.chunk_hash.ref import hash_words_np as ref_hash_words_np
from repro_torch.core import packing
from repro_torch.kernels.adaptive_quant import quant_pack
from repro_torch.kernels.chunk_hash import chunk_hash32_device
from repro_torch.kernels.chunk_hash.ops import hash_words_torch, mix_terms_torch
from repro_torch.kernels.chunk_hash.ref import mix_terms_np


def _words(n, seed=0):
    return np.random.default_rng(seed).integers(0, 2**32, size=n, dtype=np.uint32)


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 70_000])
def test_plain_hash_equals_oracle(n):
    w = _words(n, seed=n)
    assert chunk_hash32_device(torch.from_numpy(w)) == ref_hash_words_np(w)


def test_plain_hash_equals_reference_device_impls():
    w = _words(3000, seed=5)
    got = chunk_hash32_device(torch.from_numpy(w))
    assert got == ref_hash_device(jnp.asarray(w), impl="jnp")
    assert got == ref_hash_device(jnp.asarray(w), impl="interpret")


def test_words_near_the_top_of_the_range():
    w = np.array([2**32 - 1, 2**32 - 2, 2**31, 2**31 - 1, 0, 1] * 200,
                 dtype=np.uint32)
    t = torch.from_numpy(w)
    assert chunk_hash32_device(t) == ref_hash_words_np(w)
    # per-word terms, not only their sum: the int64 products stay exact
    idx = torch.arange(w.size, dtype=torch.int64) + (2**32 - w.size)
    got = mix_terms_torch(t.to(torch.int64) & 0xFFFFFFFF, idx).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32),
                                  mix_terms_np(w, start_index=2**32 - w.size))


def test_count_shorter_than_the_array():
    w = _words(5000, seed=3)
    for count in (0, 1, 4097, 4999):
        assert chunk_hash32_device(torch.from_numpy(w), count=count) == \
            ref_hash_words_np(w[:count])
        assert hash_words_torch(torch.from_numpy(w), count) == \
            ref_hash_words_np(w[:count])


def test_int32_view_of_the_words():
    w = _words(2049, seed=9)
    t = torch.from_numpy(w.view(np.int32))
    assert chunk_hash32_device(t) == ref_hash_words_np(w)


@pytest.mark.parametrize("method,bits", [("uniform_asym", b) for b in range(1, 9)]
                         + [("adaptive", b) for b in (2, 3, 4)])
def test_hash_of_quant_pack_words_is_payload_hash(method, bits):
    """Hashing the packed words over ceil(payload/4) words equals the
    reference's chunk_hash32 of the serialized payload: the tail bits past
    the last code are zero."""
    rng = np.random.default_rng(bits)
    x = torch.from_numpy(rng.normal(size=(77, 13)).astype(np.float32))
    pq = quant_pack(x, bits=bits, method=method)
    payload = packing.words_to_payload(pq.words.numpy(), pq.count, bits)
    nbytes = (pq.count * bits + 7) // 8
    assert len(payload) == nbytes
    assert chunk_hash32_device(pq.words, count=(nbytes + 3) // 4) == \
        ref_chunk_hash32(payload)
