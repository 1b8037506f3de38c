"""What the benchmark's processes import, checked in fresh interpreters:
nothing that a run loads is JAX or the JAX package ``repro`` (top-level
names compared whole: ``repro_torch`` is the program), and the plain
references load nothing of the program. Without a card the harness exits
non-zero and prints no result."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))

HARNESS = """
import sys, json
from cnr_bench import bench, cell, run, control
m = bench.load_manifest()
for x in m["end_to_end"] + m["per_layer"]:
    bench.load_reader(x["name"])
for c in m["configs"]:
    bench.load_reference(c["name"])
import repro_torch.train.loop, repro_torch.core.checkpoint, repro_torch.kernels.adaptive_quant.ops
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""

REFERENCE = """
import sys, json
from cnr_bench import bench, gen, weights, roofline
from cnr_bench.reference import chunks, train
for c in bench.load_manifest()["configs"]:
    bench.load_reference(c["name"])
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""


def _top_names(code: str):
    out = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_a_run_loads_is_jax_or_the_jax_package():
    names = _top_names(HARNESS)
    assert "repro_torch" in names and "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_the_references_load_nothing_of_the_program():
    names = _top_names(REFERENCE)
    assert "torch" in names
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_the_harness_names_forbidden_modules_by_whole_top_level_name():
    from cnr_bench.run import forbidden_modules

    assert forbidden_modules(["repro_torch", "repro_torch.core", "reprox", "torch"]) == []
    assert forbidden_modules(["repro.core.checkpoint", "jaxlib.xla", "flax", "jax"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_without_a_card_the_harness_exits_nonzero_with_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here: the harness would run the cell")
    out = subprocess.run([sys.executable, "cnr_bench/run.py", "--workload", "dlrm-rm2.train_ckpt",
                          "--seed", str(2**40 + 1), "--seconds", "1", "--trace", "0"],
                         env=ENV, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
