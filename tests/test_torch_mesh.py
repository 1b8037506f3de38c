"""The port's mesh machinery against the reference's, on the CPU with no
device mesh: the sharding rules (``dist.sharding``), the 40-cell registry
(``configs``), every cell's partition specs and the dry run's per-device
bytes (``launch.dryrun``).

The reference's side runs on a ``jax.sharding.AbstractMesh`` of the
production shape (16 × 16 ``("data", "model")``, and 2 × 16 × 16 with
``pod``), which needs no devices: ``get_cell(arch, shape, mesh=...)``, its
``state_pspecs`` (train cells) or ``params_pspecs`` (serving cells) and
``input_pspecs``. Its per-device argument bytes follow from its
``eval_shape`` trees and those specs: each leaf's local shard (each dim
over the product of its axes' sizes) times its item size, a typed PRNG key
counted as its ``uint32 (2,)`` data. The port's side builds each cell on
the ``meta`` device. Specs are compared as tuples, leaf by leaf, by path;
bytes exactly.
"""

import functools
import json
import math
import pathlib

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro import configs as ref_configs
from repro.configs import shapes as ref_shapes
from repro.dist import sharding as ref_sharding
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.dist import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.tree import flatten_with_path, keystr

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
STATE_FIELDS = ("step", "params", "opt_state", "touched", "rng")
CELLS = [(a, s, m) for a, s in ref_configs.all_cells() for m in MESHES]


def _ref_key_bytes(sds) -> int:
    if jax.dtypes.issubdtype(sds.dtype, jax.dtypes.prng_key):
        return 8  # the key's data: uint32 (2,)
    return np.dtype(sds.dtype).itemsize


def _ref_flat(tree, state: bool) -> dict:
    """{path: leaf} of a reference tree; a TrainState's first path entry
    named by its field."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    out = {}
    for path, leaf in leaves:
        head = STATE_FIELDS[path[0].key] if state else ""
        out[head + jax.tree_util.keystr(path[1:] if state else path)] = leaf
    return out


def _port_flat(tree, state: bool) -> dict:
    if state:
        tree = {f: getattr(tree, f) for f in STATE_FIELDS}
    return {(str(p[0]) + keystr(p[1:]) if state else keystr(p)): leaf
            for p, leaf in flatten_with_path(tree)}


def _ref_local_bytes(shapes_flat: dict, specs_flat: dict, sizes: dict) -> int:
    total = 0
    for k, sds in shapes_flat.items():
        spec = tuple(specs_flat[k]) + (None,) * (len(sds.shape) - len(specs_flat[k]))
        local = 1
        for d, e in zip(sds.shape, spec):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            local *= math.ceil(d / math.prod(sizes[a] for a in axes))
        total += local * _ref_key_bytes(sds)
    return total


@functools.lru_cache(maxsize=None)
def _reference(mesh_name: str) -> dict:
    """Every cell's reference specs (as tuples) and per-device bytes."""
    mesh = AbstractMesh(*MESHES[mesh_name])
    sizes = dict(mesh.shape)
    out = {}
    for arch, shape in ref_configs.all_cells():
        b = ref_configs.get_cell(arch, shape, mesh=mesh)
        state = b.kind == "train"
        tree = b.state_shapes() if state else b.params_shapes()
        specs = b.state_pspecs(tree) if state else b.params_pspecs(tree)
        t_flat, s_flat = _ref_flat(tree, state), _ref_flat(specs, state)
        i_flat = _ref_flat(b.make_inputs(), False)
        ip_flat = _ref_flat(b.input_pspecs, False)
        out[(arch, shape)] = dict(
            kind=b.kind,
            specs={k: tuple(v) for k, v in s_flat.items()},
            input_specs={k: tuple(v) for k, v in ip_flat.items()},
            tree_bytes=_ref_local_bytes(t_flat, s_flat, sizes),
            input_bytes=_ref_local_bytes(i_flat, ip_flat, sizes))
    return out


def _port_mesh(mesh_name):
    return make_production_mesh(multi_pod=mesh_name == "2x16x16")


def _same_leaves(want: dict, got: dict, what: str):
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    assert not missing and not extra, (
        f"{what}: the port lacks leaves {missing} and has leaves the reference "
        f"lacks {extra}")
    wrong = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not wrong, f"{what}: (port, reference) specs differ at {wrong}"


# ------------------------------------------------------------------ rules


def test_production_meshes_are_the_references_shapes():
    for name, (sizes, names) in MESHES.items():
        m = _port_mesh(name)
        assert m.axis_names == names and tuple(m.shape.values()) == sizes
        assert m.size == math.prod(sizes) and not m.has_group
        assert dict(m.shape) == dict(AbstractMesh(sizes, names).shape)


@pytest.mark.parametrize("pure_fsdp", [False, True])
def test_rule_sets_match_reference(pure_fsdp):
    mesh = _port_mesh("16x16")
    assert sharding.lm_rules(mesh, pure_fsdp).axis_map == \
        ref_sharding.lm_rules(None, pure_fsdp).axis_map
    assert sharding.recsys_rules(mesh).axis_map == ref_sharding.recsys_rules(None).axis_map
    assert sharding.gnn_rules(mesh).axis_map == ref_sharding.gnn_rules(None).axis_map
    assert sharding.NO_SHARDING.mesh is None and sharding.NO_SHARDING.axis_map == {}


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_pspec_gate_and_duplicates_match_reference(mesh_name):
    """``axes_for`` and ``pspec`` over every logical name of the rule sets,
    divisible and indivisible sizes, repeated mesh axes and missing dims."""
    mesh = _port_mesh(mesh_name)
    ref_mesh = AbstractMesh(*MESHES[mesh_name])
    rng = np.random.default_rng(0)
    names = [None, "batch", "heads", "kv_heads", "ff", "vocab", "experts", "seq_sp",
             "embed_rows", "d_model", "candidates", "nodes", "edges", "triplets", "nope"]
    for rules_fn in (lambda m: ref_sharding.lm_rules(m), lambda m: ref_sharding.lm_rules(m, True),
                     ref_sharding.recsys_rules, ref_sharding.gnn_rules):
        ref_rules = rules_fn(ref_mesh)
        rules = sharding.ShardingRules(mesh, dict(ref_rules.axis_map))
        for _ in range(200):
            n = int(rng.integers(1, 5))
            logical = tuple(names[i] for i in rng.integers(0, len(names), n))
            dims = tuple(int(rng.choice([0, 1, 7, 16, 48, 256, 4096, 1000])) for _ in
                         range(int(rng.integers(n - 1, n + 2))))
            assert rules.pspec(*logical, dims=dims) == tuple(ref_rules.pspec(*logical, dims=dims))
            assert rules.pspec(*logical) == tuple(ref_rules.pspec(*logical))
            for name, d in zip(logical, dims):
                assert rules.axes_for(name, d) == ref_rules.axes_for(name, d)
    x = object()
    assert sharding.lm_rules(mesh).shard(x, "batch", None) is x
    assert sharding.NO_SHARDING.pspec("batch", "heads", dims=(4, 4)) == (None, None)


def test_partition_spec_is_an_immutable_leaf():
    p = sharding.P(("data", "model"), None, "model")
    assert tuple(p) == (("data", "model"), None, "model") == tuple(JP(("data", "model"), None,
                                                                       "model"))
    assert p == sharding.P(("data", "model"), None, "model") and len(p) == 3 and p[2] == "model"
    assert hash(p) == hash(sharding.P(("data", "model"), None, "model"))
    with pytest.raises(AttributeError):
        p._entries = ()
    assert flatten_with_path({"a": p}) == [(("a",), p)]


# --------------------------------------------------------------- registry


def test_registry_covers_40_cells():
    cells = configs.all_cells()
    assert len(cells) == 40 and len(configs.ARCHS) == 10
    assert cells == ref_configs.all_cells()
    for arch in configs.ARCHS:
        assert configs.arch_family(arch) == ref_configs.arch_family(arch)
        assert configs.arch_shapes(arch) == ref_configs.arch_shapes(arch)
    assert shapes.FAMILY_SHAPES == ref_shapes.FAMILY_SHAPES
    assert shapes.FAMILY_SHAPES_REDUCED == ref_shapes.FAMILY_SHAPES_REDUCED


def test_cells_without_a_mesh_replicate():
    """No mesh: the rules are NO_SHARDING, every spec all None, the decode
    cache's spec None, as the reference's."""
    b = configs.get_cell("qwen2-0.5b", "decode_32k", reduced=True, device="meta")
    ref_b = ref_configs.get_cell("qwen2-0.5b", "decode_32k", reduced=True)
    assert b.rules.mesh is None and b.input_pspecs["cache"] is None
    assert ref_b.input_pspecs["cache"] is None
    assert all(all(e is None for e in s) for _, s in flatten_with_path(b.params_pspecs()))


# ------------------------------------------------------------ every cell


@pytest.mark.parametrize("arch,shape,mesh_name", CELLS,
                         ids=[f"{a}-{s}-{m}" for a, s, m in CELLS])
def test_cell_specs_match_reference(arch, shape, mesh_name):
    want = _reference(mesh_name)[(arch, shape)]
    b = configs.get_cell(arch, shape, device="meta", mesh=_port_mesh(mesh_name))
    assert b.kind == want["kind"]
    if b.kind == "train":
        got = _port_flat(b.state_pspecs(), True)
    else:
        got = _port_flat(b.params_pspecs(), False)
    _same_leaves(want["specs"], {k: tuple(v) for k, v in got.items()},
                 f"{arch} {shape} state" if b.kind == "train" else f"{arch} {shape} params")
    _same_leaves(want["input_specs"],
                 {k: tuple(v) for k, v in _port_flat(b.input_pspecs, False).items()},
                 f"{arch} {shape} inputs")


@pytest.mark.parametrize("arch,shape,mesh_name", CELLS,
                         ids=[f"{a}-{s}-{m}" for a, s, m in CELLS])
def test_cell_per_device_bytes_match_reference(arch, shape, mesh_name):
    want = _reference(mesh_name)[(arch, shape)]
    mesh = _port_mesh(mesh_name)
    split = dryrun.argument_bytes(configs.get_cell(arch, shape, device="meta", mesh=mesh),
                                  mesh)
    name = "state" if want["kind"] == "train" else "params"
    assert split == {name: want["tree_bytes"], "inputs": want["input_bytes"]}


def test_largest_cells_per_device_gigabytes():
    """The reference's figures on 16 × 16 (the same on 2 × 16 × 16: no rule
    maps ``pod``), to two decimals of a GB."""
    want = {("dbrx-132b", "train_4k"): 69.31, ("dbrx-132b", "long_500k"): 40.03,
            ("dbrx-132b", "decode_32k"): 37.34, ("dbrx-132b", "prefill_32k"): 34.66,
            ("nemotron-4-15b", "train_4k"): 10.08}
    for mesh_name in MESHES:
        ref = _reference(mesh_name)
        for cell, gb in want.items():
            assert round((ref[cell]["tree_bytes"] + ref[cell]["input_bytes"]) / 1e9, 2) == gb


def test_dryrun_cli_writes_the_cell(tmp_path, capsys):
    assert dryrun.main(["--arch", "dbrx-132b", "--shape", "train_4k",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "dryrun_dbrx-132b_train_4k_pod.json").read_text())
    ref = _reference("16x16")[("dbrx-132b", "train_4k")]
    assert rec["memory"]["argument_size"] == ref["tree_bytes"] + ref["input_bytes"]
    assert round(rec["memory"]["argument_size"] / 1e9, 2) == 69.31
    assert rec["status"] == "ok" and rec["n_devices"] == 256 and rec["mesh"] == "16x16"
    assert rec["card_bytes"] is None and rec["fits_card"] is None  # no card here
    assert "flops" not in rec   # no compiler: the port counts no compiled flops
    # the tensor-parallel step's collectives, counted: its all-reduces are
    # the expert-parallel MoE's 2 a layer (40 layers, 4 micro-batches), the
    # cross-entropy's 9 a micro-batch (8 chunks and the sum over data) and
    # the gradients' 2 sums (count_collectives' docstring)
    assert rec["collectives"]["counts"]["all-reduce"] == 40 * 4 * 2 + 4 * 9 + 2
    assert "tensor-parallel" in rec["collectives_note"]
    assert rec["model_flops"] == ref_configs.get_cell("dbrx-132b", "train_4k").model_flops
    assert "69.31 GB a device" in capsys.readouterr().out
    assert dryrun.main(["--arch", "dbrx-132b", "--shape", "train_4k",
                        "--out", str(tmp_path)]) == 0
    assert "cached" in capsys.readouterr().out


def test_model_flops_match_reference():
    for arch, shape in configs.all_cells():
        got = configs.get_cell(arch, shape, device="meta").model_flops
        assert got == ref_configs.get_cell(arch, shape).model_flops, (arch, shape)


# ------------------------------------------------- the table for the card

TABLE = pathlib.Path(__file__).with_name("dryrun_reference_bytes.json")


def _reference_table() -> dict:
    return {m: {f"{a}/{s}": dict(tree=r["tree_bytes"], inputs=r["input_bytes"])
                for (a, s), r in _reference(m).items()} for m in MESHES}


def test_reference_byte_table_is_the_references():
    """``dryrun_reference_bytes.json`` holds the reference's per-device
    bytes of every cell on both meshes: ``chip_smoke.py``, which has no JAX,
    holds the port's dry run on the card to it. Rewrite it with
    ``python tests/test_torch_mesh.py`` when a cell changes."""
    assert json.loads(TABLE.read_text()) == _reference_table()


if __name__ == "__main__":
    TABLE.write_text(json.dumps(_reference_table(), indent=1, sort_keys=True) + "\n")
    print(f"wrote {TABLE}")
