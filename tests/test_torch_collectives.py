"""The port's int8 error-feedback collectives (``repro_torch.dist
.collectives``) against the reference's ``repro.dist.collectives``.

Codes, scale and residual are bit-identical to the reference's on the same
inputs (one f32 max, divide, round-half-to-even and clip). The all-reduce
runs in 4 processes over a ``torch.distributed`` gloo group on the CPU,
each compressing its own shard of the gradients: the mean it returns is
held to the mean of the reference's per-shard ``compress_leaf`` outputs at
rtol/atol 1e-6 (gloo adds the 4 terms in its own order), each rank's new
residual bit-identical to the reference's for its shard; the mean is also
within the reference test's 2% of the exact mean of the gradients.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import collectives as ref
from repro_torch.dist import collectives as col

RANKS = 4


def _inputs():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(64, 64)).astype(np.float32) * 3,
            rng.normal(size=(1000,)).astype(np.float32) * 1e-3,
            np.zeros((8, 8), np.float32),
            np.array([127.0, -127.0, 0.5, -0.5, 1.5, 2.5], np.float32),
            rng.standard_cauchy(size=(33,)).astype(np.float32)]


@pytest.mark.parametrize("i", range(5))
def test_quantize_and_compress_bit_identical(i):
    x = _inputs()[i]
    r = np.random.default_rng(i).normal(size=x.shape).astype(np.float32) * 0.01
    codes, scale = col.quantize_int8(torch.from_numpy(x))
    want_c, want_s = ref.quantize_int8(jnp.asarray(x))
    assert codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_c))
    assert np.float32(scale) == np.asarray(want_s)
    np.testing.assert_array_equal(col.dequantize_int8(codes, scale).numpy(),
                                  np.asarray(ref.dequantize_int8(want_c, want_s)))
    got = col.compress_leaf(torch.from_numpy(x), torch.from_numpy(r))
    want = ref.compress_leaf(jnp.asarray(x), jnp.asarray(r))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_int8_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32))
    codes, scale = col.quantize_int8(x)
    err = (col.dequantize_int8(codes, scale) - x).abs()
    assert float(err.max()) <= float(scale) * 0.5 + 1e-7


def test_error_feedback_unbiased_over_time():
    """The accumulated transmitted signal follows the accumulated gradient:
    the residual stays bounded (the EF guarantee)."""
    rng = np.random.default_rng(1)
    g_total = np.zeros((32,), np.float32)
    sent_total = np.zeros((32,), np.float32)
    residual = torch.zeros((32,))
    for _ in range(200):
        g = torch.from_numpy(rng.normal(size=(32,)).astype(np.float32))
        codes, scale, residual = col.compress_leaf(g, residual)
        sent_total += col.dequantize_int8(codes, scale).numpy()
        g_total += g.numpy()
    assert np.abs(g_total - sent_total).max() <= float(residual.abs().max()) + 1e-4
    assert float(residual.abs().max()) < 1.0


def test_init_residuals_are_f32_zeros_of_the_tree():
    tree = {"a": torch.ones((3, 2), dtype=torch.bfloat16), "b": [torch.ones(4)]}
    res = col.init_residuals(tree)
    assert res["a"].dtype == torch.float32 and res["a"].shape == (3, 2)
    assert not res["a"].any() and res["b"][0].shape == (4,)


_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.dist.collectives import ef_allreduce_shardmap

    rank, world, port, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    data = np.load(path)
    grads = {"w": torch.from_numpy(data["w"][rank]), "b": [torch.from_numpy(data["b"][rank])]}
    res = {"w": torch.from_numpy(data["rw"][rank]), "b": [torch.from_numpy(data["rb"][rank])]}
    mean, new_res = ef_allreduce_shardmap(grads, res)
    np.savez(path.replace(".npz", f"_out{rank}.npz"), w=mean["w"].numpy(),
             b=mean["b"][0].numpy(), rw=new_res["w"].numpy(), rb=new_res["b"][0].numpy())
    dist.destroy_process_group()
    print(json.dumps({"rank": rank, "ok": True}))
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_ef_allreduce_over_four_gloo_processes(tmp_path):
    rng = np.random.default_rng(2)
    data = dict(w=rng.normal(size=(RANKS, 16, 32)).astype(np.float32),
                b=rng.normal(size=(RANKS, 128)).astype(np.float32),
                rw=rng.normal(size=(RANKS, 16, 32)).astype(np.float32) * 0.01,
                rb=np.zeros((RANKS, 128), np.float32))
    path = str(tmp_path / "in.npz")
    np.savez(path, **data)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    root = str(pathlib.Path(__file__).resolve().parents[1])
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(RANKS), port, path],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=root)
             for r in range(RANKS)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert json.loads(out.strip().splitlines()[-1])["ok"]
    for leaf, rleaf in (("w", "rw"), ("b", "rb")):
        deq, new_r = [], []
        for r in range(RANKS):
            codes, scale, nr = ref.compress_leaf(jnp.asarray(data[leaf][r]),
                                                 jnp.asarray(data[rleaf][r]))
            deq.append(np.asarray(ref.dequantize_int8(codes, scale)))
            new_r.append(np.asarray(nr))
        want = np.sum(deq, axis=0) / RANKS
        exact = data[leaf].mean(axis=0)
        for r in range(RANKS):
            got = np.load(str(tmp_path / f"in_out{r}.npz"))
            np.testing.assert_allclose(got[leaf], want, rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(got[rleaf], new_r[r])
            rel = np.abs(got[leaf] - exact).max() / np.abs(exact).max()
            assert rel < 0.02, rel  # int8 compression error ~1/127
