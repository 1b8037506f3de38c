"""The manifest (``BENCHMARK.json``) and the files the harness finds by the
names in it: ``configs/<config>.json`` with its plain reference
``configs/<config>.py``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py``. A later cell or metric comes with files and
entries of its own; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def load_traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reference(name: str) -> ModuleType:
    """The configuration's plain reference, ``configs/<name>.py``."""
    return _module(HERE / "configs" / f"{name}.py", "cnr_bench_ref_" + re.sub(r"\W", "_", name))


def load_reader(metric: str) -> ModuleType:
    """The metric's reader, ``metrics/<metric>.py``: ``read(run)`` gives
    its value, or None where the run has nothing to read."""
    return _module(HERE / "metrics" / f"{metric}.py", "cnr_bench_metric_" + re.sub(r"\W", "_", metric))


def metrics_for(manifest: dict, workload_name: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones:
    those whose ``workloads`` list it, or that have none."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[key] if workload_name in m.get("workloads", [workload_name])]
