#!/usr/bin/env python3
"""Run only the row-sharded cells of ``chip_smoke.py``'s phase 17 on one
card: 4 processes on a 2 x 2 mesh over gloo at 127.0.0.1, each calling
``chip_smoke.recsys_worker``, then ``chip_smoke._check_recsys_ranks`` on
their records. Each rank's per-cell line goes to its standard error as it
finishes, so a rank that runs out of memory shows how far it got.

  python3 tools/recsys_mesh.py                                  # every cell, RS_BATCH's batches
  python3 tools/recsys_mesh.py --cells bert4rec,dimenet --batch bert4rec=65536
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

WORKER = r"""
import datetime, json, os, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
import torch.distributed as dist

here, rank, world, port, root, batches, cells = sys.argv[1:8]
chip_smoke.RS_BATCH.update(json.loads(batches))
if cells != "all":
    chip_smoke.RS_CELLS = tuple(c for c in chip_smoke.RS_CELLS if c[0] in cells.split(","))
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=int(world),
                        rank=int(rank), timeout=datetime.timedelta(seconds=300))
try:
    from repro_torch.launch.mesh import make_host_mesh

    out = chip_smoke.recsys_worker(make_host_mesh(2, 2), root, "cuda", False)
    print(json.dumps(out), flush=True)
finally:
    dist.destroy_process_group()
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="all", help="archs, comma-separated (all: RS_CELLS)")
    ap.add_argument("--batch", action="append", default=[],
                    help="ARCH=ROWS: that cell's global batch in place of RS_BATCH's")
    args = ap.parse_args(argv)

    import chip_smoke

    batches = {k: int(v) for k, v in (b.split("=") for b in args.batch)}
    root = os.path.join(HERE, "build", "recsys_mesh")
    os.makedirs(root, exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"), OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, HERE, str(r), "4", str(port), root,
                               json.dumps(batches), args.cells],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(4)]
    try:
        outs = [p.communicate(timeout=1500) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        print(f"rank {r} exited {p.returncode}")
        lines = [ln for ln in err.splitlines() if ln.startswith("rank ") or "Error" in ln]
        print("\n".join(lines)[-4000:])
    if any(p.returncode for p in procs):
        return 1
    if args.cells == "all":
        chip_smoke._check_recsys_ranks([json.loads(o.strip().splitlines()[-1]) for o, _ in outs])
    print(f"{time.monotonic() - t0:.1f} s; {chip_smoke.card_name()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
