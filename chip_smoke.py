#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                 # every phase (needs one card)
    python3 chip_smoke.py --kernels-only  # build + kernel checks, then stop

Phases:
  1. device: no CUDA device means exit 1. Builds the hand-written kernels
     from ``src/repro_torch/kernels/csrc`` (``nvcc``, into ``build/``).
  2. kernels: each kernel against its plain PyTorch version on the card, at
     the main path's shapes, and timed beside its plain version: the
     kernel's device time from a profiler trace, and every call (kernel and
     plain version) between CUDA events; medians of 20-30 runs after
     warm-up.
  3. main path: the Trainer on dlrm-rm2 at full width (26 fields, dim 64,
     bottom MLP 13-512-256-64, top MLP 512-512-256-1, bf16 compute, batch
     65,536) with every vocabulary capped at 2^20 rows, saving 4-bit
     adaptive incremental checkpoints every 2 steps into a local store; an
     injected failure; a fresh Trainer restoring on the card and training
     on through one more save, which is waited for and checked.

The kernel table is printed as one JSON line, then the card's name and
power limit, then the last line ``{"ok": true, "device": {...}}``. Any
failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

VOCAB_CAP = 1 << 20
# H100 SXM published peaks (NVIDIA data sheet): the HBM3 rate, and 67 TFLOP/s
# of f32 outside the tensor cores = 132 SMs x 128 lanes x 2 (an FMA counts
# two) x the clock, from which the clock below follows. A kernel that fuses
# no multiply and add issues one instruction per operation, each at the
# lane rate of its pipe per clock per SM (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0): "fma" = f32
# add and multiply, 128; "alu" = f32 min/max and 32-bit integer add,
# multiply, shift and xor, 64; "xu" = conversions (float to int, and
# rintf's FRND, which that table does not list and is counted here with
# them) and the reciprocal of an IEEE divide, 16. Every instruction also
# takes an issue slot, 128 lanes per clock per SM.
PEAK_BYTES_S = 3.35e12
SMS = 132
CLOCK_HZ = 67e12 / (SMS * 128 * 2)
LANES_PER_CLOCK = {"fma": 128, "alu": 64, "xu": 16}
ISSUE_PER_CLOCK = 128


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs, each between its
    own pair of CUDA events, after ``warmup`` runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(fn, name: str, reps: int = 30) -> float:
    """Median device time of the kernels whose name contains ``name``, from
    a ``torch.profiler`` trace of ``reps`` calls of ``fn`` (after warm-up):
    unlike events around a call, it leaves out the host's launch overhead.
    Raises where the trace does not hold one such kernel per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    check(len(us) == reps, f"profiler trace holds {len(us)} {name} kernels "
          f"for {reps} calls")
    return statistics.median(us) / 1e3


def bound(nbytes: float, instrs: dict):
    """(ms, "bytes" or "operations"): the larger of ``nbytes`` over the
    memory rate and the instruction time of ``instrs`` (lane instructions
    per class, see LANES_PER_CLOCK): the busiest pipe, or issue if all
    pipes together take longer."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    clocks = max(max(n / LANES_PER_CLOCK[c] for c, n in instrs.items()),
                 sum(instrs.values()) / ISSUE_PER_CLOCK)
    t_ops = clocks / (SMS * CLOCK_HZ) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phase 1


def phase_device():
    import torch

    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.monotonic()
    build.library()
    log(f"kernels built and loaded in {time.monotonic() - t0:.2f} s "
        f"(nvcc time {build.last_build_s})")
    for lg in sorted(build.BUILD_DIR.glob("*.log")):
        log(f"--- {lg.name}\n{lg.read_text().strip()}")
    return card


# ------------------------------------------------------------------ phase 2


def _rows(gen, rows, dim, device):
    import torch

    x = torch.randn((rows, dim), generator=gen, device=device)
    return x * torch.empty((rows, 1), device=device).exponential_(generator=gen)


def _codes(pq):
    """Unpacked codes of a PackedQuant, as int64 on the host."""
    import numpy as np

    from repro_torch.core import packing

    words = pq.words.cpu().numpy()
    return packing.unpack_bits(packing.words_to_payload(words, pq.count, pq.bits),
                               pq.bits, pq.count).astype(np.int64)


def check_quant_pack(x, bits, method):
    """Kernel vs plain version on the card (and the plain version on the
    CPU) for one input. Returns the mismatch figures."""
    import numpy as np
    import torch

    from repro_torch.kernels.adaptive_quant import ops

    nb, ns = ops._resolve_steps(method, bits, None, None)
    k = ops.quant_pack_cuda(x, bits=bits, num_bins=nb, n_steps=ns)
    p = ops.quant_pack_torch(x, bits=bits, num_bins=nb, n_steps=ns)
    c = ops.quant_pack_torch(x.cpu(), bits=bits, num_bins=nb, n_steps=ns)
    torch.cuda.synchronize()
    rows, dim = x.shape
    kc, pc = _codes(k), _codes(p)
    ks, ps = k.scale.cpu().numpy(), p.scale.cpu().numpy()
    kz, pz = k.zero.cpu().numpy(), p.zero.cpu().numpy()
    deq = lambda codes, s, z: codes.reshape(rows, dim) * s[:, None] + z[:, None]
    out = dict(shape=[rows, dim], bits=bits, method=method,
               words_identical=bool(np.array_equal(k.words.cpu().numpy(),
                                                   p.words.cpu().numpy())),
               plain_cuda_vs_cpu_words_identical=bool(np.array_equal(
                   p.words.cpu().numpy(), c.words.numpy())),
               code_diff_frac=float((kc != pc).mean()),
               scale_max_abs=float(np.abs(ks - ps).max()),
               zero_max_abs=float(np.abs(kz - pz).max()),
               max_abs_err=float(np.abs(deq(kc, ks, kz) - deq(pc, ps, pz)).max()))
    if method == "uniform_asym":
        check(out["words_identical"], f"quant_pack {out}: words differ")
    else:
        check(np.allclose(ks, ps, rtol=1e-5, atol=1e-7)
              and np.allclose(kz, pz, rtol=1e-5, atol=1e-7),
              f"quant_pack {out}: scale/zero")
        check(out["code_diff_frac"] <= 2e-3, f"quant_pack {out}: codes")
    check(k.words.shape == p.words.shape, "quant_pack word count")
    return out


def phase_kernels():
    import numpy as np
    import torch

    from repro_torch.kernels.adaptive_quant import ops as aq
    from repro_torch.kernels.chunk_hash import ops as ch
    from repro_torch.kernels.chunk_hash.ref import hash_words_np

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    checks = []
    for rows, dim in ((65536, 64), (1000, 10), (333, 200)):
        x = _rows(gen, rows, dim, dev)
        for bits, method in ((2, "adaptive"), (3, "adaptive"), (4, "adaptive"),
                             (8, "uniform_asym")):
            checks.append(check_quant_pack(x, bits, method))
    log("quant_pack checks: " + json.dumps(checks))

    hash_checks = []
    for n in (0, 1, 1023, 1025, 524_288, 1_048_579):
        w = torch.randint(0, 2**32, (n,), dtype=torch.int64, generator=gen,
                          device=dev).to(torch.uint32)
        if n >= 3:  # words at the top of the range
            w[:3] = torch.tensor([2**32 - 1, 2**32 - 2, 2**31], dtype=torch.int64,
                                 device=dev).to(torch.uint32)
        hk = ch.hash_words_cuda(w, n)
        hp = ch.hash_words_torch(w, n)
        ho = hash_words_np(w.cpu().numpy())
        hash_checks.append(dict(words=n, kernel=hk, plain=hp, oracle=ho))
        check(hk == hp == ho, f"chunk_hash at {n} words: {hk} {hp} {ho}")
        if n > 1:
            check(ch.hash_words_cuda(w, n - 1) == hash_words_np(w[:n - 1].cpu().numpy()),
                  f"chunk_hash count < len at {n}")
    log("chunk_hash checks: " + json.dumps(hash_checks))

    # times at the main path's shapes: one (65536, 64) chunk, 4-bit adaptive
    x = _rows(gen, 65536, 64, dev)
    nb, ns = aq._resolve_steps("adaptive", 4, None, None)
    qp_call = lambda: aq.quant_pack_cuda(x, bits=4, num_bins=nb, n_steps=ns)
    qp_ms = kernel_ms(qp_call, "quant_pack_kernel")
    qp_call_ms = time_ms(qp_call)
    qp_plain_ms = time_ms(lambda: aq.quant_pack_torch(x, bits=4, num_bins=nb,
                                                      n_steps=ns), reps=20)
    q8_ms = kernel_ms(lambda: aq.quant_pack_cuda(x, bits=8, num_bins=1, n_steps=0),
                      "quant_pack_kernel")
    pq = aq.quant_pack_cuda(x, bits=4, num_bins=nb, n_steps=ns)
    n_el = x.numel()
    # bytes: x read once, words + scale + zero written once. Instructions
    # per value (the per-row work is left out): min, max; for each of the
    # 2*n_steps+1 candidate ranges of the search: sub, mul, max, min, rint,
    # sub, mul, add; the final code: max, min, sub, divide, rint, max, min,
    # float to uint8. An IEEE divide is one reciprocal, five f32 fma-pipe
    # instructions and one range check.
    div = {"xu": 1, "fma": 5, "alu": 1}

    def qp_instrs(n_cand):
        per = {"alu": 2 + 2 * n_cand + 4 + div["alu"],
               "fma": 5 * n_cand + 1 + div["fma"],
               "xu": n_cand + 2 + div["xu"]}
        return {c: n_el * n for c, n in per.items()}

    qp_bytes = n_el * 4 + pq.words.numel() * 4 + 2 * 65536 * 4
    qp_bound, qp_by = bound(qp_bytes, qp_instrs(2 * ns + 1))
    q8_bound, q8_by = bound(n_el * 4 + n_el + 2 * 65536 * 4, qp_instrs(0))
    main_cfg = next(c for c in checks if c["shape"] == [65536, 64] and c["bits"] == 4)

    n_words = pq.words.numel()  # 524,288: the 4-bit chunk's word stream
    acc = torch.zeros(1, dtype=torch.int32, device=dev)
    ch_call = lambda: ch.launch_sum(pq.words, n_words, acc)
    ch_ms = kernel_ms(ch_call, "chunk_hash_kernel")
    ch_call_ms = time_ms(ch_call)
    ch_plain_ms = time_ms(lambda: ch.hash_words_torch(pq.words, n_words), reps=20)
    # bytes: the words read once, the 4-byte sum written once. Integer
    # instructions per word: w + i*P2 and sum + t*P3 are one multiply-add
    # each; the multiply by P1, two shifts and two xors: 7.
    ch_bound, ch_by = bound(n_words * 4 + 4, {"alu": n_words * 7})
    log(f"quant_pack (65536, 64) 4-bit adaptive: kernel {qp_ms:.4f} ms "
        f"(profiler; one call between events {qp_call_ms:.4f} ms), plain "
        f"{qp_plain_ms:.4f} ms, bound {qp_bound:.4f} ms ({qp_by}); 8-bit "
        f"uniform_asym kernel {q8_ms:.4f} ms, bound {q8_bound:.4f} ms ({q8_by})")
    log(f"chunk_hash {n_words} words: kernel {ch_ms:.4f} ms (profiler; one "
        f"call between events {ch_call_ms:.4f} ms), plain "
        f"{ch_plain_ms:.4f} ms, bound {ch_bound:.4f} ms ({ch_by})")
    return [
        dict(name="quant_pack", route="cuda",
             source="src/repro_torch/kernels/csrc/quant_pack.cu",
             replaces="src/repro/kernels/adaptive_quant/kernel.py:206",
             launches=None, max_abs_err=main_cfg["max_abs_err"],
             ms=qp_ms, plain_ms=qp_plain_ms, bound_ms=qp_bound, bound_by=qp_by,
             library_ms=None, call_ms=qp_call_ms,
             ms_8bit_uniform=q8_ms, bound_ms_8bit_uniform=q8_bound,
             bound_by_8bit_uniform=q8_by,
             mismatch=dict(checks=len(checks),
                           max_code_diff_frac=max(c["code_diff_frac"] for c in checks),
                           uniform_words_identical=all(
                               c["words_identical"] for c in checks
                               if c["method"] == "uniform_asym"))),
        dict(name="chunk_hash", route="cuda",
             source="src/repro_torch/kernels/csrc/chunk_hash.cu",
             replaces="src/repro/kernels/chunk_hash/kernel.py:58",
             launches=None, max_abs_err=0.0,
             ms=ch_ms, plain_ms=ch_plain_ms, bound_ms=ch_bound, bound_by=ch_by,
             library_ms=None, call_ms=ch_call_ms,
             mismatch=dict(checks=len(hash_checks), all_equal=True)),
    ]


# ------------------------------------------------------------------ phase 3


def phase_main_path(kernels):
    import numpy as np
    import torch

    from repro_torch.configs import get_cell
    from repro_torch.core import (CheckNRunManager, CheckpointConfig,
                                  LocalFSStore, PAPER_DEFAULTS, scan_store)
    from repro_torch.core import manifest as mf
    from repro_torch.kernels.adaptive_quant import ops as aq
    from repro_torch.kernels.chunk_hash import ops as ch
    from repro_torch.train.loop import SimulatedFailure, Trainer, TrainerConfig

    bundle = get_cell("dlrm-rm2", "train_batch", device="cuda", vocab_cap=VOCAB_CAP)
    cfg = bundle.cfg
    check(cfg.n_sparse == 26 and cfg.embed_dim == 64
          and cfg.bot_mlp == (512, 256, 64) and cfg.top_mlp == (512, 512, 256, 1)
          and cfg.compute_dtype == torch.bfloat16
          and bundle.make_inputs()["sparse_ids"].shape[0] == 65536,
          "dlrm-rm2 at full width")
    log(f"dlrm-rm2 full width, batch 65536; reduced: every vocabulary capped at "
        f"{VOCAB_CAP} rows -> {cfg.table_rows} rows "
        f"({cfg.table_rows * cfg.embed_dim * 4 / 1e9:.2f} GB f32) instead of "
        f"187775488 (48.07 GB)")

    root = tempfile.mkdtemp(prefix="cnr-chip-smoke-")
    try:
        ckpt = CheckpointConfig(interval_batches=2, policy="intermittent",
                                quant=PAPER_DEFAULTS[4], keep_latest=10,
                                device="cuda")
        store = LocalFSStore(root)
        aq.LAUNCHES.reset()
        ch.LAUNCHES.reset()
        t0 = time.monotonic()
        tr = Trainer(bundle, store, ckpt, TrainerConfig(total_steps=6, log_every=1))
        check(tr.init_or_restore() == 0, "fresh start")
        tr.run(6)
        run_s = time.monotonic() - t0
        tr.manager.wait()  # the step-6 save, still in flight
        wait_s = time.monotonic() - t0 - run_s
        live = {k: v.cpu().numpy() for k, v in tr.state.params["tables"].items()}
        try:
            tr.run(2, fail_at_step=7)
            raise RuntimeError("the injected failure did not fire")
        except SimulatedFailure as e:
            log(f"injected: {e}")
        tr.close()
        torch.cuda.synchronize()
        train_s = time.monotonic() - t0
        launches = {"quant_pack": aq.LAUNCHES.count, "chunk_hash": ch.LAUNCHES.count}

        steps = mf.list_steps(store)
        check(steps == [2, 4, 6], f"committed steps {steps}")
        per_step = {}
        for s in steps:
            man = mf.load(store, s)
            recs = [c for t in man.tables.values() for c in t.chunks]
            check(all(c.hash32 is not None for c in recs), f"hash32 on step {s}")
            per_step[s] = dict(kind=man.kind, chunks=len(recs), nbytes=man.nbytes_total)
        log(f"saves: {json.dumps(per_step)}; launches {launches}; "
            f"stall_s {tr.stall_times}; init + 6 steps + 3 snapshots {run_s:.2f} s, "
            f"then the last save {wait_s:.2f} s; all with the failed step "
            f"{train_s:.1f} s; "
            f"losses {[round(h['loss'], 5) for h in tr.history]}")
        check(per_step[2]["kind"] == "full" and per_step[2]["chunks"] == 130,
              "first full save has 130 chunks")
        n_chunks = sum(v["chunks"] for v in per_step.values())
        check(launches["quant_pack"] == n_chunks and launches["chunk_hash"] == n_chunks,
              f"launches {launches} == quantized chunks written {n_chunks}")
        check(all(math.isfinite(h["loss"]) for h in tr.history), "finite losses")

        t0 = time.monotonic()
        rs = CheckNRunManager(LocalFSStore(root), ckpt).restore()
        check(rs.step == 6, f"restored step {rs.step}")
        tr2 = Trainer(bundle, LocalFSStore(root), ckpt,
                      TrainerConfig(total_steps=2, log_every=1))
        check(tr2.init_or_restore() == 6, "resume at step 6")
        restore_s = time.monotonic() - t0
        rel = 0.0
        for name, arr in rs.tables.items():
            got = tr2.state.params["tables"][name]
            check(got.is_cuda and torch.equal(got.cpu(), torch.from_numpy(arr)),
                  f"{name}: Trainer restore == manager.restore()")
            rel = max(rel, float(np.abs(arr - live[name]).mean()
                                 / np.abs(live[name]).mean()))
        check(0 < rel < 0.1, f"4-bit restore error {rel} within the quantization bound")
        scan = scan_store(LocalFSStore(root))
        check(scan.ok, f"integrity scan: {scan.problems}")
        # steps 7-8; step 8 saves from the restored state, through both
        # kernels. wait() raises if that save failed.
        tr2.run(2)
        tr2.manager.wait()
        tr2.close()
        resumed = {"quant_pack": aq.LAUNCHES.count - launches["quant_pack"],
                   "chunk_hash": ch.LAUNCHES.count - launches["chunk_hash"]}
        launches = {"quant_pack": aq.LAUNCHES.count, "chunk_hash": ch.LAUNCHES.count}
        check(all(math.isfinite(h["loss"]) for h in tr2.history), "finite losses after restore")
        steps = mf.list_steps(store)
        check(steps == [2, 4, 6, 8], f"committed steps after the resume {steps}")
        man8 = mf.load(store, 8)
        recs8 = [c for t in man8.tables.values() for c in t.chunks]
        check(recs8 and all(c.hash32 is not None for c in recs8), "hash32 on step 8")
        check(resumed["quant_pack"] == len(recs8) and resumed["chunk_hash"] == len(recs8),
              f"resumed launches {resumed} == step-8 chunks {len(recs8)}")
        check(scan_store(LocalFSStore(root)).ok, "integrity scan after step 8")
        log(f"restore {restore_s:.1f} s (chain {rs.chain_len}); worst table mean "
            f"rel err {rel:.5f}; scan ok; resumed losses "
            f"{[round(h['loss'], 5) for h in tr2.history]}; step-8 save "
            f"{man8.kind}, {len(recs8)} chunks, {man8.nbytes_total} B; "
            f"launches in all {launches}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        check(k["launches"] > 0, f"{k['name']} ran on the main path")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phases 1-2)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    t0 = time.monotonic()
    card = phase_device()
    kernels = phase_kernels()
    if not args.kernels_only:
        phase_main_path(kernels)
    log(f"total {time.monotonic() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
