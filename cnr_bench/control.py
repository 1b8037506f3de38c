"""Readings of a training cell's control and planted faults, at the cell's
own size, for setting its limits (not part of a benchmark run).

    python3 cnr_bench/control.py --workload dlrm-rm2.train_ckpt --seeds 11,12,13 [--program]

For each seed, against the plain reference of the cell's checked steps:

* ``control``: the reference in the program's place, every operand of a
  product rounded to fp8 e4m3, the precision below the configuration's
  bf16 (``loss_gap``, ``grad_gap``, ``change_gap``);
* ``half_batch``: the reference on the first half of each batch, the mean
  taken over it (the same three numbers);
* ``encode_3bit``: the program's own quantizer (``quant_pack``) switched
  to 3 bits, against the plain 4-bit quantizer on the seed's table rows
  (``code_mismatch``), beside ``encode_4bit``, the program as run.

With ``--program``, each seed's line also holds ``program``: the gaps of
the program's own checked steps as the cell runs them (a run with no
window; the save at the first boundary comes after the checked steps and
changes nothing in them), the readings that set each limit's lower end.

A step that returns its state unchanged reads ``change_gap`` 1 by its
definition and needs no run. Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "cnr_bench":
    sys.path.pop(0)
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def encode_mismatch(cfg, traffic, seed, bits, device, n_chunks=4):
    """Share of values whose decoded value differs between the program's
    quantizer at ``bits`` and the plain one at the traffic's bits, over
    ``n_chunks`` chunks of the largest table's rows."""
    import numpy as np
    import torch

    from cnr_bench.bench import load_reference
    from cnr_bench.reference import chunks as ref_chunks
    from cnr_bench.weights import make_weights
    from repro_torch.kernels.adaptive_quant import ops

    q = traffic["quant"]
    specs = load_reference(cfg["name"]).param_specs(cfg)
    path = max((s for s in specs if s[0][0] == "tables"), key=lambda s: s[1][0])[0]
    table = make_weights([s for s in specs if s[0] == path], seed, device)[path]
    rows = int(traffic["chunk_rows"])
    n = max(table.shape[0] // rows, 1)
    starts = np.random.default_rng([seed & 0xFFFFFFFF, 2]).choice(
        n, size=min(n_chunks, n), replace=False)
    bad = total = 0
    for s in starts:
        x = table[int(s) * rows:(int(s) + 1) * rows].contiguous()
        pq = ops.quant_pack(x, bits=bits, method=q["method"], num_bins=q["num_bins"], ratio=q["ratio"])
        words = pq.words.cpu().numpy().astype("<u4").tobytes()
        codes = ref_chunks.unpack(words, bits, x.numel(), device).reshape(x.shape)
        got = ref_chunks.dequantize(codes, pq.scale.to(torch.float16), pq.zero.to(torch.float16))
        rc, rs, rz = ref_chunks.quantize(x, q["bits"], q["num_bins"], q["ratio"])
        want = ref_chunks.dequantize(rc, rs.to(torch.float16), rz.to(torch.float16))
        bad += int((got != want).sum())
        total += x.numel()
    return bad / total


def readings(cfg: dict, traffic: dict, seed: int, device: str, program: bool = False) -> dict:
    from cnr_bench import gen
    from cnr_bench.bench import load_reference
    from cnr_bench.cell import CHECKED_STEPS, REFERENCE_BLOCK_ROWS, run_cell
    from cnr_bench.reference import train as rt

    out = {"seed": seed}
    if program:
        every = dict(cfg, limits={k: math.inf for k in rt.STEP_CHECKS})
        run = run_cell(every, dict(traffic, interval_batches=0), seed, 0.0, False, device=device)
        out["program"] = {k: v for k, (v, _) in run.checks.items()}
        out["program_detail"] = run.detail
        del run
    ref = load_reference(cfg["name"])
    stream = gen.stream_config(cfg, traffic, seed)
    batches = [gen.batch_for(stream, i) for i in range(CHECKED_STEPS)]
    kw = dict(block_rows=REFERENCE_BLOCK_ROWS)
    want = rt.reference_steps(ref, cfg, seed, batches, device, **kw)
    ctl = rt.reference_steps(ref, cfg, seed, batches, device, lp=rt.fp8, **kw)
    half = rt.reference_steps(ref, cfg, seed, batches, device, half_batch=True, **kw)
    out.update(control=rt.gaps(ctl, want), half_batch=rt.gaps(half, want),
               control_detail=rt.detail(ctl, want), half_batch_detail=rt.detail(half, want))
    if device == "cuda" and int(traffic["interval_batches"]):
        out["encode_3bit"] = encode_mismatch(cfg, traffic, seed, 3, device)
        out["encode_4bit"] = encode_mismatch(cfg, traffic, seed, traffic["quant"]["bits"], device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    from cnr_bench import bench

    cell = bench.workload(bench.load_manifest(), args.workload)
    cfg, traffic = bench.load_config(cell["config"]), bench.load_traffic(cell["traffic"])
    for s in args.seeds.split(","):
        print(json.dumps(readings(cfg, traffic, int(s), "cuda", args.program)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
