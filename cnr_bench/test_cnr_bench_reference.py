"""The plain references against small cases worked out by hand: the chunk
format's decoder, the hash, the quantizer, the training step's update and
the numbers a run is judged by."""

import math

import numpy as np
import pytest
import torch

from cnr_bench import gen
from cnr_bench.bench import load_config, load_reference
from cnr_bench.reference import chunks as rc
from cnr_bench.reference import train as rt
from cnr_bench.weights import make_weights, nest


@pytest.mark.parametrize("bits,buf,codes", [
    (4, bytes([0x21, 0x43]), [1, 2, 3, 4]),
    (2, bytes([0b11100100]), [0, 1, 2, 3]),
    (3, bytes([0b10001000, 0b00000110]), [0, 1, 2, 3, 0]),
    (8, bytes([7, 255]), [7, 255]),
])
def test_unpack_reads_the_little_endian_stream(bits, buf, codes):
    assert rc.unpack(buf, bits, len(codes), "cpu").tolist() == codes


def _hash_by_hand(words):
    """The chunk hash's definition, one word at a time in Python ints."""
    mask = 0xFFFFFFFF
    acc = 0
    for i, w in enumerate(words):
        t = (w + i * rc.PRIME2) & mask
        t ^= t >> 15
        t = (t * rc.PRIME1) & mask
        t ^= t >> 13
        t = (t * rc.PRIME3) & mask
        acc = (acc + t) & mask
    h = (acc + len(words) * rc.PRIME5) & mask
    h ^= h >> 16
    h = (h * rc.PRIME1) & mask
    h ^= h >> 13
    h = (h * rc.PRIME3) & mask
    return h ^ (h >> 16)


@pytest.mark.parametrize("payload", [b"", b"\x01", b"\x01\x00\x00\x00\xff\xff\xff\xff\x07",
                                     bytes(range(256)) * 3])
def test_hash32_is_its_definition(payload):
    padded = payload + b"\x00" * ((-len(payload)) % 4)
    words = [int.from_bytes(padded[i:i + 4], "little") for i in range(0, len(padded), 4)]
    assert rc.hash32(payload, "cpu") == _hash_by_hand(words)


def test_quantize_without_search_is_the_affine_grid():
    x = torch.tensor([[0.0, 1.0, 2.0, 3.0], [-1.0, -1.0, -1.0, -1.0]])
    codes, scale, zero = rc.quantize(x, bits=2, num_bins=1, ratio=0.0)
    assert codes.tolist() == [[0, 1, 2, 3], [0, 0, 0, 0]]
    assert scale.tolist() == [1.0, 1.0] and zero.tolist() == [0.0, -1.0]


def test_quantize_search_clips_an_outlier():
    # 31 values evenly over [0, 10] and one at 13, at 2 bits, steps of 1:
    # the full range [0, 13] errs 43.78; the search moves to [1, 12]
    # (scale 11/3), which errs 33.11
    x = torch.cat([torch.linspace(0, 10, 31), torch.tensor([13.0])])[None]
    err = lambda c, s, z: float(((c * s[:, None] + z[:, None]) - x).square().sum())
    assert err(*rc.quantize(x, bits=2, num_bins=13, ratio=0.0)) == pytest.approx(43.7778, abs=1e-3)
    codes, scale, zero = rc.quantize(x, bits=2, num_bins=13, ratio=0.2)
    assert float(zero[0]) == 1.0 and float(scale[0]) == pytest.approx(11 / 3)
    assert err(codes, scale, zero) == pytest.approx(33.1111, abs=1e-3)


def test_dequantize_uses_the_stored_half_precision():
    codes = torch.tensor([[0, 3]])
    out = rc.dequantize(codes, torch.tensor([0.5], dtype=torch.float16),
                        torch.tensor([-1.0], dtype=torch.float16))
    assert out.tolist() == [[-1.0, 0.5]]


class _Linear:
    """A toy configuration: one table of 4 rows at dim 2 and one dense
    weight of 2; the loss of an example is ``c · row + w · 1``, so every
    gradient is known by hand."""

    C = torch.tensor([1.0, -2.0])

    @staticmethod
    def param_specs(cfg):
        return [(("tables", "emb_0"), (4, 2), 1.0), (("dense", "w"), (2,), 1.0)]

    @staticmethod
    def tables(cfg):
        return [("emb_0", 0)]

    @staticmethod
    def loss_sum(p, rows, batch, cfg, lp):
        return (rows["emb_0"].sum(dim=1) @ _Linear.C).sum() + p[("dense", "w")].sum() * rows["emb_0"].shape[0]


def test_reference_step_is_row_wise_adagrad_worked_by_hand():
    seed = 5
    ids = np.array([[[1]], [[1]], [[3]], [[3]]], dtype=np.int32)       # (B=4, F=1, H=1)
    batch = dict(sparse_ids=ids, label=np.zeros(4, np.float32))
    out = rt.reference_steps(_Linear, {}, seed, [batch], "cpu", block_rows=3, lr=0.1)
    w0 = make_weights(_Linear.param_specs({}), seed, "cpu")
    # the mean over 4 examples: rows 1 and 3 each get 2/4 * C; w gets 1 a value
    g_row = 0.5 * _Linear.C
    assert out["losses"][0] == pytest.approx(float((w0[("tables", "emb_0")][ids[:, 0, 0]] @ _Linear.C).mean()
                                                   + w0[("dense", "w")].sum()), rel=1e-6)
    assert out["grad"][("tables", "emb_0")] == pytest.approx(math.sqrt(2) * float(g_row.norm()), rel=1e-6)
    assert out["grad"][("dense", "w")] == pytest.approx(math.sqrt(2), rel=1e-6)
    # row-wise: acc = mean(g²) = 2.5 / 2; a row moves by lr * g / sqrt(acc)
    move = 0.1 * float(g_row.norm()) / math.sqrt(float(g_row.square().mean()))
    assert out["change"][("tables", "emb_0")] == pytest.approx(math.sqrt(2) * move, rel=1e-5)
    # elementwise AdaGrad's first step moves each value by lr
    assert out["change"][("dense", "w")] == pytest.approx(0.1 * math.sqrt(2), rel=1e-5)


def test_gaps_by_hand():
    ref = dict(losses=[2.0, 1.0], grad={"a": 1.0, "b": 3.0, "c": 1e-9},
               change={"a": 1.0, "b": 2.0, "c": 5.0})
    prog = dict(losses=[2.2, 1.0], grad={"a": 1.5, "b": 3.0, "c": 1e-9},
                change={"a": 1.1, "b": 2.0, "c": 0.0})
    g = rt.gaps(prog, ref)
    assert g["loss_gap"] == pytest.approx(0.1)
    # median leaf gradient 1.0: a's gap 0.5 / max(1, 1)
    assert g["grad_gap"] == pytest.approx(0.5)
    # c's gradient is under a thousandth of the median: left out of the change
    assert g["change_gap"] == pytest.approx(0.1 / 1.5)


@pytest.mark.parametrize("name", ["dlrm-rm2", "xdeepfm"])
def test_bce_of_a_zero_logit_is_log_two(name):
    ref = load_reference(name)
    assert float(ref.bce_sum(torch.zeros(3), torch.tensor([0.0, 1.0, 1.0]))) == pytest.approx(3 * math.log(2))


@pytest.mark.parametrize("name", ["dlrm-rm2", "xdeepfm"])
def test_dense_flops_of_the_published_widths(name):
    cfg = load_config(name)
    f = load_reference(name).dense_flops(cfg, 1)
    if name == "dlrm-rm2":
        # 13-512-256-64, 27² · 64 dots, 415-512-512-256-1
        want = 2 * (13 * 512 + 512 * 256 + 256 * 64) + 2 * 27 * 27 * 64 \
            + 2 * (415 * 512 + 512 * 512 + 512 * 256 + 256)
    else:
        want = 2 * (39 * 39 * 10 + 200 * 39 * 39 * 10) + 2 * 2 * (200 * 39 * 10 + 200 * 200 * 39 * 10) \
            + 2 * (390 * 400 + 400 * 400 + 400)
    assert f == want


def test_weights_repeat_for_a_seed_and_nest_into_lists():
    specs = [(("dense", "bot", 0, "w"), (3, 2), 0.5), (("dense", "bot", 1, "w"), (2, 2), 1.0),
             (("dense", "bias"), (), 0.0)]
    a, b = make_weights(specs, 2**40 + 3, "cpu"), make_weights(specs, 2**40 + 3, "cpu")
    assert all(torch.equal(a[p], b[p]) for p in a)
    tree = nest(a)
    assert isinstance(tree["dense"]["bot"], list) and tree["dense"]["bot"][1]["w"].shape == (2, 2)
    assert float(tree["dense"]["bias"]) == 0.0


def test_ids_alone_are_the_batch_ids():
    s = gen.RecsysStreamConfig(batch=64, n_dense=3, n_sparse=4, vocab_sizes=(5, 100, 7, 1000), seed=2**35)
    assert np.array_equal(gen.recsys_ids(s, 9), gen.recsys_batch(s, 9)["sparse_ids"])
    assert not np.array_equal(gen.recsys_ids(s, 9), gen.recsys_ids(s, 10))
