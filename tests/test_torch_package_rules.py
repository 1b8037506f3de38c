"""Package rules of the PyTorch port (``src/repro_torch``).

* It imports neither JAX nor the reference package ``repro``, statically
  (an AST scan of every file) and at run time (a subprocess imports every
  module, runs a tiny CPU save→restore and inspects ``sys.modules``).
* ``device="cuda"`` without a card raises; nothing falls back to the CPU.
"""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"


def _py_files():
    return sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", _py_files(),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    depth = len(path.relative_to(PKG).parts) - 1  # package levels below repro_torch
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                # a relative import may climb to repro_torch, never above it
                assert node.level - 1 <= depth, (
                    f"{path}:{node.lineno} leaves the package")
                continue
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (
                f"{path}:{node.lineno} imports {n}")


def test_subprocess_imports_and_round_trip_without_jax(tmp_path):
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        import numpy as np
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        from repro_torch.core import (CheckNRunManager, CheckpointConfig,
                                      LocalFSStore, PAPER_DEFAULTS, Snapshot)
        rng = np.random.default_rng(0)
        tab = rng.normal(size=(300, 8)).astype(np.float32)
        snap = Snapshot(step=1, tables={{"emb": tab}},
                        row_state={{"emb": {{"opt_acc": np.ones(300, np.float32)}}}},
                        touched={{"emb": np.ones(300, bool)}},
                        dense={{"w": np.eye(3, dtype=np.float32)}}, extra={{}})
        mgr = CheckNRunManager(LocalFSStore({str(tmp_path)!r}), CheckpointConfig(
            quant=PAPER_DEFAULTS[8], async_write=False, device="cpu"))
        mgr.save(snap).result()
        rs = mgr.restore()
        mgr.close()
        assert rs.step == 1 and np.abs(rs.tables["emb"] - tab).max() < 0.05
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cuda_without_card_raises_in_the_manager(monkeypatch):
    from repro_torch.core import CheckNRunManager, CheckpointConfig, InMemoryStore

    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CheckNRunManager(InMemoryStore(), CheckpointConfig())


def test_cuda_without_card_raises_in_the_cell(monkeypatch):
    from repro_torch.configs import get_cell

    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_cell("dlrm-rm2", "train_batch", reduced=True)


def test_cuda_without_card_raises_in_the_bert4rec_cells(monkeypatch):
    from repro_torch.configs import get_cell

    _no_card(monkeypatch)
    for shape in ("train_batch", "serve_p99"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_cell("bert4rec", shape, reduced=True)


def test_cuda_without_card_raises_in_the_launcher(monkeypatch, tmp_path):
    from repro_torch.launch import train

    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "dlrm-rm2", "--shape", "train_batch",
                    "--steps", "2", "--ckpt-dir", str(tmp_path)])


def test_cuda_without_card_raises_in_the_serve_launcher(monkeypatch, tmp_path):
    from repro_torch.launch import serve

    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--ckpt-dir", str(tmp_path)])


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel paths never run on a CPU tensor: the kernel entries raise,
    and the public ops take their plain versions without a launch."""
    from repro_torch.kernels.adaptive_quant import ops as aq
    from repro_torch.kernels.chunk_hash import ops as ch

    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        aq.quant_pack_cuda(x, bits=4, num_bins=45, n_steps=9)
    before = aq.LAUNCHES.count
    aq.quant_pack(x, bits=4)
    aq.quant_codes(x, bits=4)
    assert aq.LAUNCHES.count == before
    w = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ch.hash_words_cuda(w, 8)
    before = ch.LAUNCHES.count
    ch.chunk_hash32_device(w)
    assert ch.LAUNCHES.count == before


def test_launcher_runs_on_cpu_when_asked(tmp_path, capsys):
    from repro_torch.launch import train

    rc = train.main(["--arch", "dlrm-rm2", "--shape", "train_batch",
                     "--steps", "4", "--interval", "2", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path)])
    assert rc == 0
    assert "checkpoint bytes written" in capsys.readouterr().out
