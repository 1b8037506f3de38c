"""Run one cell of the Check-N-Run port's benchmark once, on the card(s)
of this machine, and print its result as one JSON line.

    python3 cnr_bench/run.py --workload dlrm-rm2.train_ckpt --seed 7 --seconds 30 --trace 0

Run from the root of a checkout that holds ``BENCHMARK.json``,
``cnr_bench/`` and ``src/repro_torch`` (the program under test). With
``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a ``torch.profiler`` trace
of the window. The last lines on standard error, and the result's last
key, give each number the run was judged by beside its limit.

Exits non-zero, and prints no result, without CUDA cards enough for the
cell, when the program is not there, or when the process has imported
JAX or the JAX package ``repro`` by the time the window closes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# run as a script, the folder itself leads sys.path: its modules are only
# ever imported as ``cnr_bench.*``
if sys.path and Path(sys.path[0]).resolve() == ROOT / "cnr_bench":
    sys.path.pop(0)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _setup_paths() -> None:
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    # every build and kernel cache of the run lives in the checkout
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (the loaded modules'),
    compared whole (``repro_torch`` is not ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class ForbiddenImport(RuntimeError):
    pass


def _check_imports() -> None:
    bad = forbidden_modules()
    if bad:
        raise ForbiddenImport(f"the process has imported {bad}")


def result_line(run, manifest: dict, workload: str, trace: bool, device: dict) -> dict:
    from cnr_bench.bench import load_reader, metrics_for

    metrics = {}
    for m in metrics_for(manifest, workload, trace):
        v = load_reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out = {"correct": all(v <= lim for v, lim in run.checks.values()),
           "attempted": run.steps, "failed": run.failed_saves,
           "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        out["device"] = dict(device, busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_paths()

    from cnr_bench import bench

    manifest = bench.load_manifest()
    cell = bench.workload(manifest, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from cnr_bench.cell import run_cell

    cfg = bench.load_config(cell["config"])
    traffic = bench.load_traffic(cell["traffic"])
    try:
        run = run_cell(cfg, traffic, args.seed, args.seconds, bool(args.trace),
                       device="cuda", on_window_end=_check_imports)
    except ForbiddenImport as e:
        print(f"{e}: no result", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]), "memory_peak_bytes": run.memory_peak_bytes}
    line = result_line(run, manifest, args.workload, bool(args.trace), device)
    for sv in run.traced_saves:
        print(f"save step {sv['step']} {sv['kind']} {sum(c[0] for c in sv['chunks'])} rows "
              f"{len(sv['chunks'])} chunks stall {sv['stall_s']:.3f} s commit after "
              f"{sv['t_commit'] - sv['t_start']:.3f} s", file=sys.stderr)
    print(f"window {run.window_s:.3f} s, {run.steps} steps, step ms p50 "
          f"{sorted(run.step_ms)[len(run.step_ms) // 2] if run.step_ms else 0:.1f}, "
          f"setup {run.setup_s:.2f} s", file=sys.stderr)
    if run.trace is not None:
        names = [n for n, _ in run.trace["kernels"]]
        print(f"trace {len(names)} device events, {run.trace['lost_launches']} kernel launches "
              f"without a device record, quant_pack {sum('quant_pack' in n for n in names)}, "
              f"chunk_hash {sum('chunk_hash' in n for n in names)} launches for "
              f"{sum(len(s['chunks']) for s in run.traced_saves)} chunks", file=sys.stderr)
    print(f"detail {json.dumps(run.detail)}", file=sys.stderr)
    for k, (v, lim) in run.checks.items():
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
