#!/usr/bin/env python3
"""Run only the LM cells of ``chip_smoke.py``'s phase 17 on one card: 4
processes over gloo at 127.0.0.1, each calling ``chip_smoke.lm_worker``
(the five ``train_4k`` cells' held mesh steps, then the launcher runs),
then ``chip_smoke._check_lm_ranks`` on their records. Each rank's
per-cell line goes to its standard error as it finishes, so a rank that
runs out of memory shows how far it got.

  python3 tools/lm_mesh.py                                # every cell
  python3 tools/lm_mesh.py --cells qwen2-0.5b,dbrx-132b --no-launcher
  python3 tools/lm_mesh.py --layers qwen2-0.5b=24 --batch dbrx-132b=2
  python3 tools/lm_mesh.py --cells olmoe-1b-7b --no-launcher --unforced
  python3 tools/lm_mesh.py --device cpu --reduced         # a CPU rehearsal
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

WORKER = r"""
import datetime, json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
import torch.distributed as dist

here, rank, world, port, root, cells, over, launcher, device, reduced, forced = sys.argv[1:12]
over = json.loads(over)   # {arch: {"layers": n, "batch": b}}
chip_smoke.LM_CELLS = tuple(
    (a, m, over.get(a, {}).get("layers", n), over.get(a, {}).get("batch", b))
    for a, m, n, b in chip_smoke.LM_CELLS if cells == "all" or a in cells.split(","))
if launcher == "0":
    chip_smoke.LM_LAUNCHED = ()
chip_smoke.LM_FORCE_ROUTING = forced == "1"
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=int(world),
                        rank=int(rank), timeout=datetime.timedelta(seconds=600))
try:
    out = chip_smoke.lm_worker(root, device, reduced == "1")
    print(json.dumps(out), flush=True)
finally:
    dist.destroy_process_group()
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="all", help="archs, comma-separated (all: LM_CELLS)")
    ap.add_argument("--layers", action="append", default=[],
                    help="ARCH=N: that cell's held depth in place of LM_CELLS'")
    ap.add_argument("--batch", action="append", default=[],
                    help="ARCH=B: that cell's global batch in place of LM_CELLS'")
    ap.add_argument("--no-launcher", action="store_true", help="skip the launcher runs")
    ap.add_argument("--unforced", action="store_true",
                    help="the MoE cells' one-process step routes on its own, not as the "
                         "mesh did (its gradients then miss where a token routed otherwise)")
    ap.add_argument("--out", default=None, help="write every rank's record to this JSON file")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)

    import chip_smoke

    over = {}
    for key, values in (("layers", args.layers), ("batch", args.batch)):
        for a, v in (x.split("=") for x in values):
            over.setdefault(a, {})[key] = int(v)
    root = tempfile.mkdtemp(prefix="lm-mesh-")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"), OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, HERE, str(r), "4", str(port), root,
                               args.cells, json.dumps(over),
                               "0" if args.no_launcher else "1", args.device,
                               "1" if args.reduced else "0", "0" if args.unforced else "1"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(4)]
    try:
        outs = [p.communicate(timeout=1500) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
        shutil.rmtree(root, ignore_errors=True)
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        print(f"rank {r} exited {p.returncode}")
        lines = [ln for ln in err.splitlines() if ln.startswith("rank ") or "Error" in ln]
        print("\n".join(lines)[-4000:])
    if any(p.returncode for p in procs):
        return 1
    ranks = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(ranks, f, indent=1)
    if (args.device == "cuda" and args.cells == "all" and not args.no_launcher
            and not args.unforced):
        chip_smoke._check_lm_ranks(ranks)
    else:
        print(json.dumps(ranks[0])[-6000:])
    card = chip_smoke.card_name() if args.device == "cuda" else "the CPU"
    print(f"{time.monotonic() - t0:.1f} s; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
