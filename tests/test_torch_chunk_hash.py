"""The port's plain chunk hash against the reference's numpy oracle and its
device implementations (jitted jnp, and the Pallas kernel in interpret
mode), and a numpy model of the CUDA kernel's partition and collection
against the oracle. A 32-bit sum is exact in any order, so every
comparison is equality.
"""

import re
from pathlib import Path

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
from repro_torch.kernels.chunk_hash.ops import (hash_value, hash_words_async,
                                                hash_words_torch, hash_words_torch_async,
                                                mix_terms_torch)
from repro_torch.kernels.chunk_hash.ref import finalize as finalize_ref
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


# ---------------------------------------------------------------------------
# A numpy model of how csrc/chunk_hash.cu spreads the sum over the card and
# collects it, with the kernel's own constants read from its source: the
# words before the first 16-byte boundary go one to a thread, the rest as
# uint4s to threads in grid-stride order, the last count mod 4 words one to
# a thread; each block sums its threads and adds its sum, mod 2**32, into
# one word zeroed before the launch, in whatever order the blocks finish;
# the host finalizes that word.

_CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc/chunk_hash.cu"


def _kernel_constants():
    src = _CSRC.read_text()
    get = lambda name: re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
    product = lambda text: int(np.prod([int(f) for f in text.split("*")]))
    return dict(threads=int(get("kThreads")), max_blocks=product(get("kMaxBlocks")),
                vec=int(get("kVecPerThread")))


def _model_partials(words: np.ndarray, byte_offset: int):
    """(per-block sums mod 2**32, number of times each word was taken)."""
    c = _kernel_constants()
    n = words.size
    head = min(n, (16 - byte_offset % 16) % 16 // 4)
    nvec = (n - head) // 4
    blocks = min(max(1, -(-nvec // (c["threads"] * c["vec"]))), c["max_blocks"])
    nthreads = blocks * c["threads"]
    tail = head + 4 * nvec
    assert n - tail < 4 and head < 4
    i = np.arange(n, dtype=np.int64)
    owner = np.where(i < head, i, np.where(i < tail, (i - head) // 4 % nthreads, i - tail))
    assert (owner < nthreads).all()
    per_thread = np.zeros(nthreads, dtype=np.uint64)
    np.add.at(per_thread, owner, mix_terms_np(words).astype(np.uint64))
    taken = np.bincount(np.concatenate([i[:head], i[head:tail], i[tail:]]), minlength=n)
    parts = per_thread.reshape(blocks, c["threads"]).sum(axis=1) & 0xFFFFFFFF
    return [int(p) for p in parts], taken


def _model_collect(parts, order):
    """The blocks' 32-bit atomicAdds into the zeroed sum, in ``order``."""
    acc = np.zeros(1, dtype=np.uint32)
    for b in order:
        acc += np.uint32(parts[b])  # wraps mod 2**32, as atomicAdd does
    return int(acc[0])


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1023, 524_288, 1_048_579])
def test_kernel_partition_gives_the_oracles_hash(offset, n):
    """Every word is taken exactly once, at any view offset (0-3 words past
    a 16-byte boundary) and tail (n - head mod 4), and the blocks' adds
    give, finalized on the host, ref.chunk_hash32's value in any block
    order."""
    w = _words(n, seed=n + offset)
    parts, taken = _model_partials(w, 4 * offset)
    assert (taken == 1).all()
    rng = np.random.default_rng(offset)
    for order in (range(len(parts)), rng.permutation(len(parts))):
        assert finalize_ref(_model_collect(parts, order), n) == ref_hash_words_np(w)
    assert ref_chunk_hash32(w.tobytes()) == ref_hash_words_np(w)


def test_block_sums_wrap_mod_2_32():
    """At the grid's largest size, with every block's sum at its largest,
    the 32-bit adds wrap to the true sum mod 2**32, in any order."""
    blocks = _kernel_constants()["max_blocks"]
    parts = [2**32 - 1] * (blocks - 1) + [12345]
    want = sum(parts) & 0xFFFFFFFF
    for order in (range(blocks), reversed(range(blocks))):
        assert _model_collect(parts, order) == want
    assert finalize_ref(want, 7) == finalize_ref(sum(parts), 7)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_async_hash_of_quant_pack_words_is_payload_hash(bits):
    """The asynchronous entry's plain counterpart (a CPU tensor) holds the
    terms' sum; hash_value finalizes it to ref.chunk_hash32 of the
    serialized payload."""
    rng = np.random.default_rng(100 + bits)
    x = torch.from_numpy(rng.normal(size=(513, 64)).astype(np.float32))
    pq = quant_pack(x, bits=bits, method="adaptive" if bits in (2, 4) else "uniform_asym")
    payload = packing.words_to_payload(pq.words.numpy(), pq.count, bits)
    count = (len(payload) + 3) // 4
    s = hash_words_async(pq.words, count=count)
    assert s.dtype == torch.int32 and s.shape == (1,) and s.device == pq.words.device
    assert hash_value(s, count) == ref_chunk_hash32(payload) == hash_words_torch(pq.words, count)


def test_hash_value_reads_sums_with_the_top_bit_set():
    seen_high = False
    for seed in range(16):
        w = _words(257, seed=seed)
        s = hash_words_torch_async(torch.from_numpy(w), 257)
        seen_high |= int(mix_terms_np(w).astype(np.uint64).sum()) & 0x80000000 != 0
        assert hash_value(s, 257) == ref_hash_words_np(w)
    assert seen_high
