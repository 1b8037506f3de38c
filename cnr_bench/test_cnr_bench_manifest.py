"""The manifest (``BENCHMARK.json``) against the benchmark's contract, and
every file the harness finds by a name in it."""

import json
import re
from pathlib import Path

import pytest

from cnr_bench import bench
from cnr_bench.reference.train import STEP_CHECKS

ROOT = Path(__file__).resolve().parent.parent
M = bench.load_manifest()
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
ALL_METRICS = M["end_to_end"] + M["per_layer"]


def test_manifest_has_exactly_the_contract_keys():
    assert set(M) == TOP
    assert len(json.dumps(M)) <= 64 * 1024
    assert M["command"] == ["python3", "cnr_bench/run.py"]
    assert M["paths"] == ["cnr_bench"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)


def test_run_seconds_fits_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", M["configs"], ids=lambda c: c["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert bench.NAME.match(entry["name"])
    assert entry["file"] == f"cnr_bench/configs/{entry['name']}.json"
    cfg = bench.load_config(entry["name"])
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert (ROOT / "cnr_bench" / "configs" / f"{entry['name']}.py").is_file()
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert bench.NAME.match(key) and key in cfg
        assert not re.search(r"(_dim|_rank|hidden|intermediate|latent|state|proj|head)", key)
    for text in (entry["why"], entry["source"]):
        assert LINE.match(text)


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda w: w["name"])
def test_workload_entry(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert bench.NAME.match(cell["name"]) and bench.NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and LINE.match(cell["why"])
    bench.config_of(M, cell["config"])
    assert (ROOT / "cnr_bench" / "traffic" / f"{cell['traffic']}.json").is_file()
    e2e = [m["name"] for m in bench.metrics_for(M, cell["name"], False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert bench.metrics_for(M, cell["name"], True)


@pytest.mark.parametrize("metric", ALL_METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    per_layer = metric in M["per_layer"]
    keys = ({"name", "unit", "better", "source", "layer", "moves"} if per_layer
            else {"name", "unit", "better", "bound", "source"})
    assert set(metric) - {"workloads"} == keys
    assert bench.NAME.match(metric["name"]) and bench.UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    reader = bench.load_reader(metric["name"])
    assert callable(reader.read)
    cells = metric.get("workloads", [w["name"] for w in M["workloads"]])
    for c in cells:
        bench.workload(M, c)
    if per_layer:
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(metric["layer"])
        target = next(m for m in M["end_to_end"] if m["name"] == metric["moves"])
        for c in cells:
            assert target in bench.metrics_for(M, c, False)
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in M[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in ALL_METRICS]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_config_is_used_and_has_its_limits():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    exact = ("code_mismatch", "rows_wrong", "hash_bad", "raw_wrong")
    for name in used:
        limits = bench.load_config(name)["limits"]
        assert set(exact) <= set(limits) <= set(exact) | set(STEP_CHECKS)
        assert "change_gap" in limits and {"grad_gap", "grad_gap_median"} & set(limits)
        assert all(limits[k] == 0 for k in exact)


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "cnr_bench").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
