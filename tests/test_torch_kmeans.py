"""The port's k-means quantizers (paper §4.2.2, ``repro_torch.core.
quantize``) against the reference's, on the reference's own skewed rows.

The Fig. 5 orderings of ``tests/test_quantize.py`` hold on the port. Then,
for each quantizer at 2, 3 and 4 bits on the same (256, 64) rows: the
codebooks are allclose to the reference's (rtol 1e-5, atol 1e-6: Lloyd's
means summed in another order round differently in their last bits), a
code may differ only where a value's two nearest centroids lie within 1e-6
of each other (a tie, which such a last bit decides) and at most 2e-3 of
the codes may, the block ids are equal, and ``kmeans_dequantize`` gives the
reference's values exactly for the same codes and codebook. The quantile
init takes a value set past 2^24 elements (``torch.quantile`` refuses
one).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantize import KmeansQuantized as RefKmeansQuantized
from repro_torch.core import (
    KmeansQuantized,
    adaptive_quantize,
    dequantize,
    kmeans_block_quantize,
    kmeans_clustered_quantize,
    kmeans_dequantize,
    kmeans_quantize,
    mean_l2_loss,
    uniform_quantize,
)

ref_q = importlib.import_module("repro.core.quantize")
port_q = importlib.import_module("repro_torch.core.quantize")

QUANTIZERS = {
    "per_vector": lambda m, x, bits: m.kmeans_quantize(x, bits),
    "blocks": lambda m, x, bits: m.kmeans_block_quantize(x, bits, n_blocks=8),
    "clustered": lambda m, x, bits: m.kmeans_clustered_quantize(x, bits, n_blocks=8),
}


def skewed_rows(rows=128, dim=64, seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(rows, dim)) *
            r.gamma(1.0, 1.0, size=(rows, 1))).astype(np.float32)


def test_paper_orderings_fig5():
    """Qualitative Fig. 5 orderings at 3 bits: per-vector kmeans ≈ adaptive <
    naive asym < sym; contiguous-block kmeans worse than uniform."""
    x = torch.from_numpy(skewed_rows(256, 64))
    bits = 3
    l_sym = float(mean_l2_loss(x, dequantize(uniform_quantize(x, bits, True))))
    l_asym = float(mean_l2_loss(x, dequantize(uniform_quantize(x, bits, False))))
    l_ad = float(mean_l2_loss(x, dequantize(adaptive_quantize(x, bits, 25, 0.2))))
    l_km = float(mean_l2_loss(x, kmeans_dequantize(kmeans_quantize(x, bits))))
    l_blk = float(mean_l2_loss(x, kmeans_dequantize(
        kmeans_block_quantize(x, bits, n_blocks=8))))
    l_clu = float(mean_l2_loss(x, kmeans_dequantize(
        kmeans_clustered_quantize(x, bits, n_blocks=8))))
    assert l_asym < l_sym
    assert l_ad < l_asym
    assert abs(l_km - l_ad) / l_ad < 0.25       # adaptive ≈ per-vector kmeans
    assert l_blk > l_asym                        # contiguous blocks lose
    assert l_clu < l_blk                         # 2-tier better than contiguous


def _books_per_row(q, rows):
    books = np.asarray(q.codebook)
    return books if q.block_ids is None else books[np.asarray(q.block_ids)]


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("method", sorted(QUANTIZERS))
def test_matches_reference(method, bits):
    x = skewed_rows(256, 64)
    want = QUANTIZERS[method](ref_q, jnp.asarray(x), bits)
    got = QUANTIZERS[method](port_q, torch.from_numpy(x), bits)
    assert isinstance(got, KmeansQuantized) and got.bits == bits
    assert got.codes.dtype == torch.uint8 and got.codebook.dtype == torch.float32
    np.testing.assert_allclose(got.codebook.numpy(), np.asarray(want.codebook),
                               rtol=1e-5, atol=1e-6)
    if want.block_ids is None:
        assert got.block_ids is None
    else:
        np.testing.assert_array_equal(got.block_ids.numpy(), np.asarray(want.block_ids))
    codes, ref_codes = got.codes.numpy(), np.asarray(want.codes)
    assert codes.shape == ref_codes.shape == x.shape
    differ = codes != ref_codes
    assert differ.mean() <= 2e-3
    if differ.any():   # only at ties: the two nearest centroids within 1e-6
        d = np.sort(np.abs(x[..., None] - _books_per_row(want, 256)[:, None, :]), -1)
        assert np.all((d[..., 1] - d[..., 0])[differ] <= 1e-6)
    # the same codes and codebook dequantize to the reference's values
    ref_deq = np.asarray(ref_q.kmeans_dequantize(want))
    same = KmeansQuantized(torch.tensor(ref_codes), torch.tensor(
        np.asarray(want.codebook)), None if want.block_ids is None else
        torch.tensor(np.asarray(want.block_ids)), bits=bits)
    np.testing.assert_array_equal(kmeans_dequantize(same).numpy(), ref_deq)
    assert isinstance(want, RefKmeansQuantized)


def test_quantile_init_past_2_to_the_24():
    """``kmeans_clustered_quantize`` seeds its codebooks by a quantile over
    every element of the table: 64,028,672 at MIND's (1,000,448, 64). The
    port's init is held bit for bit to ``jnp.quantile`` itself, called as
    the reference's ``kmeans_clustered_quantize`` calls it."""
    n = (1 << 24) + 1
    vals = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    want = np.asarray(jnp.quantile(jnp.asarray(vals),
                                   (jnp.arange(8, dtype=jnp.float32) + 0.5) / 8))
    got = port_q._quantile_init(torch.from_numpy(vals), 8).numpy()
    np.testing.assert_array_equal(got, want)
    # Why the port computes the position in f32: there, n = 2^24 + 1 rounds
    # to 2^24, so the positions q (n - 1) are not the exact ones, and the
    # two neighbours of each are weighted by its f32 fraction.
    f32 = np.float32
    pos = ((np.arange(8, dtype=f32) + f32(0.5)) / f32(8)) * (f32(n) - f32(1))
    lo = np.floor(pos)
    srt = np.sort(vals)
    np.testing.assert_array_equal(want, srt[lo.astype(np.int64)] * (f32(1) - (pos - lo))
                                  + srt[np.ceil(pos).astype(np.int64)] * (pos - lo))
    assert not np.array_equal(pos, np.round(pos))
