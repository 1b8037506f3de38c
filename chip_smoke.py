#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                 # every phase (needs one card)
    python3 chip_smoke.py --kernels-only  # build + kernel checks, then stop

Phases:
  1. device: no CUDA device means exit 1. Builds the hand-written kernels
     from ``src/repro_torch/kernels/csrc`` (``nvcc``, into ``build/``) and
     reads what was compiled (``cuobjdump -sass``): ``dot_interaction``'s
     bf16 route issues HMMA, ``adaptive_quant`` divides only out of line,
     ``chunk_hash`` issues at most one global atomic, the f32 attention no
     tensor-core instruction.
  2. kernels: each kernel against its plain PyTorch version on the card, at
     the main paths' shapes, and timed beside its plain version and, where
     one PyTorch call computes the same function, that call: the kernel's
     device time from a profiler trace, and every call between CUDA
     events; medians of 20-30 runs after warm-up.
  3. training: the Trainer on dlrm-rm2 at full width (26 fields, dim 64,
     bottom MLP 13-512-256-64, top MLP 512-512-256-1, bf16 compute, batch
     65,536) with every vocabulary capped at 2^20 rows, saving 4-bit
     adaptive incremental checkpoints every 2 steps into a local store; an
     injected failure; a fresh Trainer restoring on the card and training
     on through one more save, which is waited for and checked. Its path
     runs ``quant_pack`` and ``chunk_hash``.
  4. serving, from that store: the newest chain restored into the
     ``serve_p99`` bundle (batch 512), about 200 request batches, then a
     few ``serve_bulk`` batches (262,144); the kernel path's probabilities
     against the same forward through the plain versions; a
     ``CheckpointSubscriber`` following the store into an
     ``EmbeddingServer``, bit-equal to ``restore()``, then catching up on
     one more training save by its delta alone. Its path runs
     ``embedding_bag`` (one launch a batch for all 26 fields) and
     ``dot_interaction``.

  5. bert4rec at full width (1,000,448 items, dim 64, 2 blocks of 2 heads
     of 32, seq 200, d_ff 256, bf16 compute): the Trainer at batch 65,536
     (4 micro-batches) through 4-bit adaptive saves, a restore and one more
     save (``quant_pack`` and ``chunk_hash``); serving from that chain,
     ``serve_p99`` (batch 512, 100 candidates each, 200 batches and a
     20-batch trace) and ``serve_bulk`` (262,144 rows in slices of 65,536,
     a warm-up batch and 3 timed), both blocks attending through
     ``flash_attention``'s tensor-core route (bf16), every launch of it; the scores through the kernel against the plain
     version; and the ``adaptive_quant`` op on the trained item table at 2,
     3, 4 and 8 bits, its L2 error against uniform quantization's.

Each path's launch counters are set to 0 just before it and read just
after; every kernel of a path must have launched in it, and a kernel's
``launches`` in the table is its count over the paths.

The kernel table is printed as one JSON line, then the card's name and
power limit, then the last line ``{"ok": true, "device": {...}}``. Any
failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

VOCAB_CAP = 1 << 20
# embedding_bag's large-table check: 33,554,944 x 64 f32 (8.6 GB) holds
# more than 2^31 values, so its last rows' element offsets pass 2^31
BIG_ROWS = 33_554_944
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
PEAK_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores
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
    A trace that does not hold one such kernel per call is taken again
    (``_traced``)."""
    import torch

    def matching(prof):
        return [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]

    prof = _traced(fn, reps, lambda p: len(matching(p)) == reps,
                   lambda p: f"{len(matching(p))} {name} kernels for {reps} calls")
    return statistics.median(matching(prof)) / 1e3


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call of ``fn``, all of its kernels summed, from a
    ``torch.profiler`` trace of ``reps`` calls after warm-up: a library
    call's kernel time, whatever its kernels are named, to set beside a
    hand-written kernel's ``kernel_ms``."""
    import torch

    def device_us(prof):
        return [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    prof = _traced(fn, reps, lambda p: sum(device_us(p)) > 0, lambda p: "no device time")
    return sum(device_us(prof)) / reps / 1e3


RETAKEN_TRACES = [0]  # traces _traced has taken again so far in this run


def _traced(fn, reps, ok, what, attempts=8):
    """A ``torch.profiler`` trace of ``reps`` calls of ``fn`` (after
    warm-up) of which ``ok(trace)`` holds; ``what(trace)`` says what a
    failed one held. A trace that fails ``ok`` is taken again after a
    pause (the profiler has been seen to drop one event of 20, in one run
    events of three traces in a row, and once to record no device event
    at all); raises if the last of ``attempts`` fails too. Each retake is
    counted in ``RETAKEN_TRACES``, which a kernel's entry in the result
    line reports as ``retaken_traces``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        if ok(prof):
            return prof
        log(f"profiler trace held {what(prof)}; again")
        RETAKEN_TRACES[0] += 1
        time.sleep(0.5)
    check(False, f"profiler trace holds {what(prof)}")


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


def sass_counts(lib_path: str, names, opcodes) -> dict:
    """{function: {opcode: count}} from ``cuobjdump -sass`` of a built
    library, for the functions whose (mangled) name holds one of ``names``:
    what the compiler made of a kernel, read without running it."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                             "cuobjdump")
    out = subprocess.run([shutil.which("cuobjdump") or cuobjdump, "-sass", lib_path],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {lib_path}: {out.stderr[-500:]}")
    funcs, cur = {}, None
    for line in out.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1) if any(n in m.group(1) for n in names) else None
            if cur:
                funcs[cur] = dict.fromkeys(opcodes, 0)
        elif cur and "/*" in line:
            for op in opcodes:
                if re.search(r"\b" + re.escape(op) + r"\b", line):
                    funcs[cur][op] += 1
    return funcs


def check_sass(lib_path: str) -> dict:
    """The instruction mix the kernels redesigned for the card rest on:
    ``dot_interaction``'s bf16 route issues HMMA (its f32 route none);
    ``chunk_hash`` at most one global atomic; ``flash_attention``'s f32
    route no HMMA or HGMMA; each
    ``adaptive_quant`` kernel holds at most one FCHK (the check an IEEE
    divide makes: the one divide, in ``exact_code``, reached by CALL from
    the window's branch) and fewer MUFU.RCP than the 16 values a lane
    holds per candidate (one ``__frcp_rn`` per candidate range in its
    unrolled code, and the divide's)."""
    counts = sass_counts(lib_path, ("dot_interaction", "adaptive_quant", "chunk_hash",
                                    "flash_kernel_f32"),
                         ("HMMA", "HGMMA", "MUFU.RCP", "FCHK", "CALL", "ATOMG", "ATOM",
                          "REDG", "RED"))
    mma = {f: c for f, c in counts.items() if "dot_interaction_mma" in f}
    simt = {f: c for f, c in counts.items()
            if "dot_interaction" in f and "dot_interaction_mma" not in f}
    aq = {f: c for f, c in counts.items() if "adaptive_quant_kernel" in f}
    check(len(mma) == 4 and all(c["HMMA"] > 0 for c in mma.values()),
          f"dot_interaction's bf16 route issues HMMA: {mma}")
    check(len(simt) == 1 and all(c["HMMA"] == 0 for c in simt.values()),
          f"f32 route: {simt}")
    check(len(aq) == 12 and all(c["FCHK"] <= 1 and c["MUFU.RCP"] < 16 and c["CALL"] > 0
                                for c in aq.values()),
          f"adaptive_quant's kernels divide only out of line: {aq}")
    # chunk_hash: one global atomic, a block's add to the sum (the earlier
    # kernel issued one a warp); the f32 attention keeps
    # full f32 products, on no tensor core
    ch = {f: c for f, c in counts.items() if "chunk_hash_kernel" in f}
    check(len(ch) == 1 and all(c["ATOMG"] + c["ATOM"] + c["REDG"] + c["RED"] <= 1
                               for c in ch.values()),
          f"chunk_hash issues at most one global atomic: {ch}")
    f32 = {f: c for f, c in counts.items() if "flash_kernel_f32" in f}
    check(len(f32) == 4 and all(c["HMMA"] == 0 and c["HGMMA"] == 0 for c in f32.values()),
          f"the f32 attention issues no tensor-core instruction: {f32}")
    return dict(dot_interaction_mma=mma, dot_interaction_f32=simt, adaptive_quant=aq,
                chunk_hash=ch, flash_attention_f32=f32)


def record_launches(kernels, path: str, counts: dict) -> None:
    """Add one path's launch counts to the kernel table: ``launches`` is a
    kernel's count over the paths, ``launches_by_path`` each path's."""
    for k in kernels:
        if k["name"] in counts:
            k.setdefault("launches_by_path", {})[path] = counts[k["name"]]
            k["launches"] = sum(k["launches_by_path"].values())


EMPTY_KERNEL_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_kernel_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def build_empty_kernel():
    """An empty kernel, built with the kernels' flags into
    ``build/empty_kernel/``: its profiler time is the floor every launch
    pays, set beside a kernel whose bound a launch outlasts. Returns a call
    that launches it on the current stream."""
    import ctypes

    import torch

    from repro_torch.kernels import build as kb

    out = kb.BUILD_DIR / "empty_kernel"
    out.mkdir(parents=True, exist_ok=True)
    (out / "empty.cu").write_text(EMPTY_KERNEL_CU)
    p = subprocess.run([kb._nvcc()] + kb.ARCH_FLAGS + kb.COMMON_FLAGS
                       + ["-shared", str(out / "empty.cu"), "-o", str(out / "empty.so")],
                       capture_output=True, text=True, timeout=300)
    check(p.returncode == 0, f"nvcc of the empty kernel: {p.stdout[-500:]}{p.stderr[-500:]}")
    lib = ctypes.CDLL(str(out / "empty.so"))
    lib.empty_kernel_launch.argtypes = [ctypes.c_void_p]
    lib.empty_kernel_launch.restype = ctypes.c_int

    def launch():
        check(lib.empty_kernel_launch(torch.cuda.current_stream().cuda_stream) == 0,
              "empty kernel launched")
    return launch


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


def _device_split(prof, n_batches, groups, top=6):
    """Device time per batch by kernel group from a profiler trace, and the
    ``top`` kernels by device time (names cut to 60 characters)."""
    import torch

    dev_ms, by_name = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.lower()
            group = next((g for g, keys in groups.items()
                          if any(key in name for key in keys)), "other")
            ms = e.time_range.elapsed_us() / 1e3 / n_batches
            dev_ms[group] = dev_ms.get(group, 0.0) + ms
            by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + ms
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dev_ms, {k: round(v, 4) for k, v in ranked}


# ------------------------------------------------------------------ phase 1


def phase_device():
    import torch

    from repro_torch.kernels import build

    card = card_name()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.monotonic()
    build.library()
    log(f"kernels built and loaded in {time.monotonic() - t0:.2f} s "
        f"(nvcc time {build.last_build_s})")
    for lg in sorted(build.BUILD_DIR.glob("*.log")):
        log(f"--- {lg.name}\n{lg.read_text().strip()}")
    log("sass: " + json.dumps(check_sass(build.library()._name)))
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
    # dims 64 and 128 are whole multiples of 32 (codes packed in registers
    # at 2, 4 and 8 bits, and 2 and 4); 10, 16, 96 and 200 leave lanes
    # part-filled (shared memory)
    for rows, dim in ((65536, 64), (1000, 10), (333, 200), (500, 16), (300, 96),
                      (257, 128)):
        x = _rows(gen, rows, dim, dev)
        for bits, method in ([(b, "adaptive") for b in (2, 3, 4)]
                             + [(b, "uniform_asym") for b in range(1, 9)]):
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
    # views 4, 8 and 12 bytes past a 16-byte boundary, at counts that are
    # not multiples of 4; then 500 calls on one buffer without a reset
    base = torch.randint(0, 2**32, (1_048_579 + 3,), dtype=torch.int64, generator=gen,
                         device=dev).to(torch.uint32)
    host = base.cpu().numpy()
    for off in (1, 2, 3):
        for n in (1, 5, 1023, 524_287, 1_048_579):
            hk = ch.hash_value(ch.hash_words_async(base[off:off + n], n), n)
            ho = hash_words_np(host[off:off + n])
            hash_checks.append(dict(words=n, offset_words=off, kernel=hk, oracle=ho))
            check(hk == ho, f"chunk_hash at {n} words from offset {off}: {hk} {ho}")
    counts = [524_288 - 7 * i for i in range(500)]
    outs = [ch.hash_words_async(base, c) for c in counts]
    repeated = ([ch.hash_value(h, c) for h, c in zip(outs, counts)]
                == [hash_words_np(host[:c]) for c in counts])
    hash_checks.append(dict(repeated_calls=len(counts), all_equal=repeated))
    check(repeated, "chunk_hash over 500 calls on one stream without a reset")
    log("chunk_hash checks: " + json.dumps(hash_checks))

    # times at the main path's shapes: one (65536, 64) chunk, 4-bit adaptive
    qp_retaken = RETAKEN_TRACES[0]
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
    # 2*n_steps+1 candidate ranges of the search: sub, mul, max, min, the
    # rounding's two adds (r + 1.5*2^23 - 1.5*2^23), sub, mul, add; the
    # final code: max, min, sub, divide, the rounding's two adds, max, min,
    # float to uint. An IEEE divide is one reciprocal, five f32 fma-pipe
    # instructions and one range check.
    div = {"xu": 1, "fma": 5, "alu": 1}

    def qp_instrs(n_cand):
        per = {"alu": 2 + 2 * n_cand + 4 + div["alu"],
               "fma": 7 * n_cand + 3 + div["fma"],
               "xu": 1 + div["xu"]}
        return {c: n_el * n for c, n in per.items()}

    qp_bytes = n_el * 4 + pq.words.numel() * 4 + 2 * 65536 * 4
    qp_bound, qp_by = bound(qp_bytes, qp_instrs(2 * ns + 1))
    q8_bound, q8_by = bound(n_el * 4 + n_el + 2 * 65536 * 4, qp_instrs(0))
    main_cfg = next(c for c in checks if c["shape"] == [65536, 64] and c["bits"] == 4)

    qp_retaken = RETAKEN_TRACES[0] - qp_retaken
    ch_retaken = RETAKEN_TRACES[0]
    n_words = pq.words.numel()  # 524,288: the 4-bit chunk's word stream
    # the save path's call: a 4-byte memset and one launch, no PyTorch
    # fill, the sum left on the card
    ch_call = lambda: ch.hash_words_cuda_async(pq.words, n_words)
    ch_ms = kernel_ms(ch_call, "chunk_hash_kernel")
    ch_device_ms = device_ms(ch_call)
    ch_call_ms = time_ms(ch_call)
    ch_plain_ms = time_ms(lambda: ch.hash_words_torch(pq.words, n_words), reps=20)
    floor_ms = kernel_ms(build_empty_kernel(), "empty_kernel")
    ch_retaken = RETAKEN_TRACES[0] - ch_retaken
    # bytes: the words read once, the 4-byte hash written once. Integer
    # instructions per word: w + i*P2 and sum + t*P3 are one multiply-add
    # each; the multiply by P1, two shifts and two xors: 7.
    ch_bound, ch_by = bound(n_words * 4 + 4, {"alu": n_words * 7})
    log(f"quant_pack (65536, 64) 4-bit adaptive: kernel {qp_ms:.4f} ms "
        f"(profiler; one call between events {qp_call_ms:.4f} ms), plain "
        f"{qp_plain_ms:.4f} ms, bound {qp_bound:.4f} ms ({qp_by}, "
        f"{qp_bound / qp_ms:.1%} of it); 8-bit uniform_asym kernel {q8_ms:.4f} "
        f"ms, bound {q8_bound:.4f} ms ({q8_by}, {q8_bound / q8_ms:.1%})")
    log(f"chunk_hash {n_words} words: kernel {ch_ms:.4f} ms (profiler; all device "
        f"time of a call {ch_device_ms:.4f} ms; one call between events "
        f"{ch_call_ms:.4f} ms), plain {ch_plain_ms:.4f} ms, bound {ch_bound:.5f} ms "
        f"({ch_by}); an empty kernel {floor_ms:.4f} ms (profiler), the launch floor")
    serve_kernels = check_and_time_serve_kernels(gen, dev)
    b4r_kernels = [check_and_time_flash(gen, dev), check_and_time_adaptive_quant(gen, dev)]
    return [
        dict(name="quant_pack", route="cuda",
             source="src/repro_torch/kernels/csrc/quant_pack.cu",
             replaces="src/repro/kernels/adaptive_quant/kernel.py:206",
             launches=None, max_abs_err=main_cfg["max_abs_err"],
             ms=qp_ms, plain_ms=qp_plain_ms, bound_ms=qp_bound, bound_by=qp_by,
             library_ms=None, call_ms=qp_call_ms, retaken_traces=qp_retaken,
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
             library_ms=None, call_ms=ch_call_ms, device_ms=ch_device_ms,
             empty_kernel_ms=floor_ms, retaken_traces=ch_retaken,
             mismatch=dict(checks=len(hash_checks), all_equal=True)),
    ] + serve_kernels + b4r_kernels


def _rotating(fn, args_list):
    """A call of ``fn`` on the next argument tuple of ``args_list`` each
    time: with more than the 50 MB L2 in the list, each call reads its
    inputs from device memory, as a new request batch does."""
    nxt = itertools.cycle(args_list).__next__
    return lambda: fn(*nxt())


def _bf16_ulps(got, want):
    """|got - want| in units of want's bf16 ulp (2^(e-8) for want = m 2^e,
    m in [0.5, 1))."""
    import torch

    _, e = torch.frexp(want.float())
    return (got.float() - want.float()).abs() / torch.ldexp(torch.ones_like(want.float()), e - 8)


def check_and_time_serve_kernels(gen, dev):
    """``embedding_bag`` and ``dot_interaction`` against their plain
    versions on the card, then timed at the serving shapes: batch 512
    (serve_p99) and 262,144 (serve_bulk); for the lookup 26 tables of 2^20
    x 64 f32 (the capped vocabulary), H = 1, all fields in one launch into
    bf16; features (B, 27, 64) bf16."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.dot_interaction import ops as di
    from repro_torch.kernels.embedding_bag import ops as eb

    V, D, NF = VOCAB_CAP, 64, 26
    tables = [torch.randn((V, D), generator=gen, device=dev) for _ in range(NF)]
    table = tables[0]
    eb_checks = []

    def check_eb(tab, ids, exact):
        """The kernel with one table (f32 out) against the plain version."""
        k = eb.embedding_bag_cuda(tab, ids)
        p = eb.embedding_bag_torch(tab, ids)
        err = float((k - p).abs().max()) if k.numel() else 0.0
        out = dict(fields=1, shape=[tab.shape[0], tab.shape[1], ids.shape[0], ids.shape[1]],
                   bit_equal=bool(torch.equal(k, p)), max_abs_err=err)
        eb_checks.append(out)
        if exact:
            check(out["bit_equal"], f"embedding_bag {out}: not bit-equal")
        else:
            check(torch.allclose(k, p, rtol=1e-5, atol=1e-5), f"embedding_bag {out}")

    def check_fields(tabs, ids, bad=()):
        """All fields in one launch (bf16 out) against the plain version:
        bit-equal at H = 1, within one bf16 ulp at H > 1. The (b, f) bags
        in ``bad`` hold an out-of-range id and must come out NaN; the plain
        version, which cannot take such an id, gets 0 there."""
        k = eb.embedding_bag_fields_cuda(tabs, ids)
        good = ids.clone()
        for b, f in bad:
            good[b, f, :] = 0
        p = eb.embedding_bag_fields_torch(tabs, good)
        nan = torch.isnan(k).all(dim=-1)
        keep = ~nan
        out = dict(fields=len(tabs), ids=list(ids.shape), dim=tabs[0].shape[1],
                   vocabs=sorted({t.shape[0] for t in tabs})[:4],
                   bit_equal=bool(torch.equal(k[keep], p[keep])),
                   max_bf16_ulps=float(_bf16_ulps(k[keep], p[keep]).max()),
                   max_abs_err=float((k[keep].float() - p[keep].float()).abs().max()),
                   nan_bags=int(nan.sum()))
        eb_checks.append(out)
        check(out["nan_bags"] == len(bad) and all(bool(nan[b, f]) for b, f in bad),
              f"embedding_bag fields {out}: NaN bags")
        if ids.shape[2] == 1:
            check(out["bit_equal"], f"embedding_bag fields {out}: not bit-equal")
        else:
            check(out["max_bf16_ulps"] <= 1.0, f"embedding_bag fields {out}")

    def rand_ids(B, vocabs, H):
        return torch.stack([torch.randint(0, v, (B, H), generator=gen, device=dev)
                            for v in vocabs], dim=1).to(torch.int32)

    for B in (512, 262144):
        check_eb(table, torch.randint(0, V, (B, 1), generator=gen, device=dev,
                                      dtype=torch.int32), exact=True)
        check_fields(tables, rand_ids(B, [V] * NF, 1))
    for v, d, b, h in ((1000, 64, 32, 4), (512, 10, 16, 1), (2048, 200, 8, 7),
                       (100, 128, 64, 2)):
        check_eb(torch.randn((v, d), generator=gen, device=dev),
                 torch.randint(0, v, (b, h), generator=gen, device=dev,
                               dtype=torch.int32), exact=False)
    # F of 1 to 64, H > 1, D not a multiple of 4, unequal vocabularies
    for b, h, d, vocabs in ((300, 1, 64, [70]), (64, 3, 16, [20 + 7 * f for f in range(40)]),
                            (33, 4, 10, [5, 900, 31, 2, 64]), (17, 7, 200, [300, 11, 4096]),
                            (128, 2, 64, [4096 + f for f in range(26)]), (5, 1, 4, [9] * 64)):
        check_fields([torch.randn((v, d), generator=gen, device=dev) for v in vocabs],
                     rand_ids(b, vocabs, h))
    # an id past its own table's rows (though inside another's), and a -1
    vocabs = [50, 500, 7, 64, 300, 9]
    ids = rand_ids(40, vocabs, 3)
    ids[7, 2, 1] = 7
    ids[11, 0, 0] = -1
    check_fields([torch.randn((v, 32), generator=gen, device=dev) for v in vocabs], ids,
                 bad=((7, 2), (11, 0)))
    big = torch.randn((BIG_ROWS, D), generator=gen, device=dev)
    big_ids = torch.randint(BIG_ROWS - 65536, BIG_ROWS, (4096, 1), generator=gen,
                            device=dev, dtype=torch.int32)
    big_ids[-1, 0] = BIG_ROWS - 1
    check_eb(big, big_ids, exact=True)
    check_fields([table, big, table],
                 torch.stack([big_ids[:, 0] % V, big_ids[:, 0], big_ids[:, 0] % 1000],
                             dim=1)[:, :, None])
    del big, big_ids
    torch.cuda.empty_cache()
    log("embedding_bag checks: " + json.dumps(eb_checks))

    di_checks = []
    # bf16 (the tensor cores): the serve shapes, a batch that is not a
    # multiple of 4 rows, F = 2, one to four m-tiles (F = 17, 33, 40, 64),
    # D = 1, 8, 10, 24, 128 (not a multiple of 16, or of 8: element-wise
    # staging), and features at an address that is not 16-byte aligned
    shapes = [(b, f, d, torch.bfloat16) for b, f, d in (
        (512, 27, 64), (262144, 27, 64), (513, 27, 64), (3, 2, 1), (1, 2, 16),
        (5, 33, 64), (7, 40, 10), (130, 64, 128), (9, 17, 8), (33, 16, 24),
        (70001, 27, 64))]
    shapes += [(b, f, d, torch.float32) for b, f, d in (
        (64, 27, 64), (128, 40, 10), (32, 8, 16), (256, 14, 128), (5, 33, 64), (3, 2, 1))]
    shapes.append((513, 27, 64, "bf16, at an offset of 2 bytes"))
    for b, f, d, dt in shapes:
        if isinstance(dt, str):
            x = torch.randn((b * f * d + 1,), generator=gen, device=dev).to(
                torch.bfloat16)[1:].view(b, f, d)
        else:
            x = torch.randn((b, f, d), generator=gen, device=dev).to(dt)
        k, p = di.dot_interaction_cuda(x), di.dot_interaction_torch(x)
        out = dict(shape=[b, f, d], dtype=str(dt).split(".")[-1],
                   max_abs_err=float((k - p).abs().max()),
                   max_rel_err=float(((k - p).abs() / p.abs().clamp_min(1e-6)).max()))
        di_checks.append(out)
        check(torch.allclose(k, p, rtol=1e-4, atol=1e-4), f"dot_interaction {out}")
    for f, d in ((65, 8), (64, 1024)):  # shapes the bf16 route refuses
        try:
            di.dot_interaction_cuda(torch.zeros((2, f, d), device=dev, dtype=torch.bfloat16))
            check(False, f"dot_interaction refuses bf16 F={f}, D={d}")
        except ValueError:
            pass
    log("dot_interaction checks: " + json.dumps(di_checks))

    # times at the serving shapes; each timed call reads fresh ids/features.
    # The library call for the lookup: one F.embedding_bag over the 26
    # tables concatenated (once, here), the ids shifted by each table's
    # first row (f32 out: it has no bf16 output for f32 tables)
    cat = torch.cat(tables)
    first_row = torch.arange(NF, device=dev, dtype=torch.int64)[None, :, None] * V

    def eb_times(B):
        # rows read per call: 1.7 GB over 512 sets of 512 x 26 ids, 1.7 GB
        # per set of 262,144 x 26
        sets = [(tables, rand_ids(B, [V] * NF, 1)) for _ in range(512 if B == 512 else 2)]
        lib_sets = [((i.long() + first_row).view(-1, 1), cat) for _, i in sets]
        one_field = [(table, i[:, 0, :]) for _, i in sets]
        # bytes: each id's row read, the ids, each bag written in bf16;
        # H = 1: no adds
        b_ms, b_by = bound(B * NF * (D * 4 + 4 + D * 2), {"fma": 0})
        return dict(
            ms=kernel_ms(_rotating(eb.embedding_bag_fields_cuda, sets),
                         "embedding_bag_kernel"),
            call_ms=time_ms(_rotating(eb.embedding_bag_fields_cuda, sets)),
            plain_ms=time_ms(_rotating(eb.embedding_bag_fields_torch, sets), reps=20),
            library_ms=time_ms(_rotating(
                lambda i, t: F.embedding_bag(i, t, mode="sum"), lib_sets), reps=20),
            library_device_ms=device_ms(_rotating(
                lambda i, t: F.embedding_bag(i, t, mode="sum"), lib_sets)),
            one_field_ms=kernel_ms(_rotating(eb.embedding_bag_cuda, one_field),
                                   "embedding_bag_kernel"),
            bound_ms=b_ms, bound_by=b_by)

    def di_times(B, dt=torch.bfloat16):
        # bf16: 113 MB of features in 64 sets of 512 rows, 906 MB per set of
        # 262,144 (f32: twice that)
        sets = [(torch.randn((B, 27, D), generator=gen, device=dev).to(dt),)
                for _ in range(64 if B == 512 else 2)]
        iu, ju = (torch.from_numpy(a).to(dev) for a in np.triu_indices(27, k=1))
        pairs = 27 * 26 // 2
        # bytes: the features read, the f32 dots written; operations: a
        # multiply and an add per feature element per pair, bf16 on the
        # tensor cores, f32 as one FMA instruction on the CUDA cores
        t_bytes = (B * 27 * D * sets[0][0].element_size() + B * pairs * 4) / PEAK_BYTES_S * 1e3
        if dt == torch.bfloat16:
            t_ops = 2.0 * B * pairs * D / PEAK_BF16_FLOPS * 1e3
        else:
            t_ops = bound(0, {"fma": B * pairs * D})[0]
        lib = _rotating(lambda x: torch.bmm(x, x.transpose(1, 2))[:, iu, ju], sets)
        return dict(
            ms=kernel_ms(_rotating(di.dot_interaction_cuda, sets),
                         "dot_interaction_mma_kernel" if dt == torch.bfloat16
                         else "dot_interaction_kernel"),
            call_ms=time_ms(_rotating(di.dot_interaction_cuda, sets)),
            plain_ms=time_ms(_rotating(di.dot_interaction_torch, sets), reps=20),
            library_ms=time_ms(lib, reps=20), library_device_ms=device_ms(lib),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")

    retaken = RETAKEN_TRACES[0]
    eb_t = {B: eb_times(B) for B in (512, 262144)}
    eb_retaken = RETAKEN_TRACES[0] - retaken
    del tables, table, cat
    torch.cuda.empty_cache()
    retaken = RETAKEN_TRACES[0]
    di_t = {B: di_times(B) for B in (512, 262144)}
    di_f32 = {B: di_times(B, torch.float32) for B in (512, 262144)}  # on no path
    di_retaken = RETAKEN_TRACES[0] - retaken
    for B, r in eb_t.items():
        log(f"embedding_bag, 26 fields in one launch, batch {B}: kernel {r['ms']:.4f} "
            f"ms (profiler; {r['bound_ms'] / r['ms']:.1%} of the bound; one call "
            f"between events {r['call_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
            f"F.embedding_bag over the concatenated tables {r['library_ms']:.4f} ms "
            f"(device {r['library_device_ms']:.4f} ms), bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}); one field alone {r['one_field_ms']:.4f} ms")
    for (B, dt), r in itertools.chain((((B, "bf16"), r) for B, r in di_t.items()),
                                      (((B, "f32"), r) for B, r in di_f32.items())):
        log(f"dot_interaction batch {B}, {dt}: kernel {r['ms']:.4f} ms (profiler; "
            f"{r['bound_ms'] / r['ms']:.1%} of the bound; one call between events "
            f"{r['call_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, bmm + gather "
            f"{r['library_ms']:.4f} ms (device {r['library_device_ms']:.4f} ms), bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})")

    def entry(name, src, replaces, t, checks, err, shape, keys=(), **extra):
        bulk, p99 = t[262144], t[512]
        main = ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bound_by") + keys
        return dict(name=name, route="cuda", source=src, replaces=replaces,
                    launches=None, max_abs_err=err, shape=shape,
                    **{k: bulk[k] for k in main},
                    serve_p99={k: p99[k] for k in main},
                    checks=len(checks), **extra)

    return [
        entry("embedding_bag", "src/repro_torch/kernels/csrc/embedding_bag.cu",
              "src/repro/kernels/embedding_bag/kernel.py:23", eb_t, eb_checks,
              max(c["max_abs_err"] for c in eb_checks),
              "serve_bulk, batch 262144 x 26 fields, one launch",
              ("library_device_ms", "one_field_ms"), retaken_traces=eb_retaken),
        entry("dot_interaction", "src/repro_torch/kernels/csrc/dot_interaction.cu",
              "src/repro/kernels/dot_interaction/kernel.py:22", di_t, di_checks,
              max(c["max_abs_err"] for c in di_checks),
              "serve_bulk, (262144, 27, 64) bf16, tensor cores", ("library_device_ms",),
              retaken_traces=di_retaken, f32_route=dict(launches_on_paths=0, **{
                  f"batch_{B}": r for B, r in di_f32.items()})),
    ]


B4R_ITEMS = 1_000_448  # bert4rec's published catalog, padded to 512


def flash_bound(B, Sq, Sk, Hq, D, itemsize):
    """(ms, "bytes" or "operations") for one attention call: q, k, v read
    once and o written once against the two products' FLOPs (bf16 on the
    tensor cores; f32, which the f32 route keeps, at the 67 TFLOP/s of f32
    FMAs) and the softmax's exps on the 16-lane conversion pipe."""
    t_bytes = (2 * B * Sq * Hq * D + 2 * B * Sk * Hq * D) * itemsize / PEAK_BYTES_S * 1e3
    peak = PEAK_BF16_FLOPS if itemsize == 2 else 67e12
    t_mma = 4.0 * B * Hq * Sq * Sk * D / peak * 1e3
    t_exp = B * Hq * Sq * Sk / (LANES_PER_CLOCK["xu"] * SMS * CLOCK_HZ) * 1e3
    t_ops = max(t_mma, t_exp)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_and_time_flash(gen, dev):
    """``flash_attention`` against its plain version on the card, on both
    routes (bf16: the tensor-core kernel; f32: the SIMT kernel): the
    reference's test shapes, bert4rec's serving shapes (batch 512, and one
    65,536-row slice of serve_bulk) causal and not, and the tensor-core
    tiling's ragged cases (S of 1, 17, 200, 257; D of 16 to 128; 4 q heads
    on one kv head; Sq != Sk; keys past one staged chunk). Then timed at the
    bert4rec shapes, not causal, beside ``F.scaled_dot_product_attention``
    on the same inputs: bf16 at batch 512 and on the slice, f32 at 512."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.bert4rec import SERVE_SLICE_ROWS as B4R_SLICE
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fr

    checks = []
    f32, bf16 = torch.float32, torch.bfloat16
    # (B, Sq, Sk, Hq, Hkv, D, causal, dtype)
    shapes = [(2, 128, 128, 4, 2, 64, True, f32), (1, 256, 256, 8, 8, 32, False, f32),
              (2, 128, 128, 2, 1, 100, True, f32), (1, 192, 192, 4, 4, 64, True, f32),
              (1, 128, 128, 4, 2, 64, True, bf16), (2, 200, 200, 2, 2, 32, False, f32)]
    shapes += [(b, 200, 200, 2, 2, 32, c, dt) for b in (512, B4R_SLICE) for c in (False, True)
               for dt in (bf16, f32)]
    shapes += [(3, 17, 17, 4, 1, 16, True, dt) for dt in (bf16, f32)]
    # the f32 route's other head widths, 8-key tails and keys past its
    # shared-memory budget (staged in chunks)
    shapes += [(b, sq, sk, hq, hkv, d, c, f32) for b, sq, sk, hq, hkv, d, c in (
        (2, 45, 1025, 4, 1, 128, True), (2, 45, 257, 4, 1, 48, False),
        (3, 17, 1, 4, 1, 1, True), (2, 200, 200, 4, 1, 32, True),
        (1, 64, 1500, 2, 2, 32, False))]
    shapes += [(b, sq, sk, hq, hkv, d, c, bf16) for b, sq, sk, hq, hkv, d, c in (
        (2, 257, 257, 4, 1, 64, False), (4, 1, 200, 2, 2, 32, False),
        (2, 200, 17, 2, 1, 128, False), (2, 257, 130, 2, 2, 100, True),
        (1, 17, 257, 4, 1, 128, True), (2, 200, 200, 4, 1, 32, True),
        (1, 300, 700, 4, 2, 64, False), (2, 600, 600, 2, 1, 128, True),
        (1, 64, 1500, 2, 2, 32, False), (1, 1, 1, 1, 1, 1, True))]
    for B, Sq, Sk, Hq, Hkv, D, causal, dt in shapes:
        q = torch.randn((B, Sq, Hq, D), generator=gen, device=dev).to(dt)
        k, v = (torch.randn((B, Sk, Hkv, D), generator=gen, device=dev).to(dt)
                for _ in range(2))
        route = fa.MMA_LAUNCHES if dt == bf16 else fa.SIMT_LAUNCHES
        before = route.count
        got = fa.flash_attention_cuda(q, k, v, causal=causal)
        check(route.count == before + 1, f"{dt} went through its route")
        want = fr.flash_attention_torch(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = 2e-3 if dt == f32 else 3e-2
        out = dict(shape=[B, Sq, Sk, Hq, Hkv, D], causal=causal,
                   dtype=str(dt).split(".")[-1], max_abs_err=err, tol=tol)
        checks.append(out)
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"flash_attention {out}")
        del q, k, v, got, want
    torch.cuda.empty_cache()
    log("flash_attention checks: " + json.dumps(checks))

    def times(B, n_sets, dt, symbol):
        sets = [tuple(torch.randn((B, 200, 2, 32), generator=gen, device=dev)
                      .to(dt) for _ in range(3)) for _ in range(n_sets)]
        kern = _rotating(lambda q, k, v: fa.flash_attention_cuda(q, k, v, causal=False), sets)
        lib = _rotating(lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)), sets)
        b_ms, b_by = flash_bound(B, 200, 200, 2, 32, sets[0][0].element_size())
        r = dict(ms=kernel_ms(kern, symbol), call_ms=time_ms(kern),
                 plain_ms=time_ms(_rotating(lambda q, k, v: fr.flash_attention_torch(
                     q, k, v, causal=False), sets), reps=5 if B > 512 else 20),
                 library_ms=time_ms(lib, reps=20), library_device_ms=device_ms(lib),
                 bound_ms=b_ms, bound_by=b_by)
        r["frac_of_bound"] = b_ms / r["ms"]
        # kernel time against the library's, each from the profiler; and
        # one call against one call, each between events
        r["vs_library"] = r["ms"] / r["library_device_ms"]
        r["call_vs_library_call"] = r["call_ms"] / r["library_ms"]
        del sets
        torch.cuda.empty_cache()
        return r

    # 8 sets of 13 MB each at batch 512 exceed the 50 MB L2, as new request
    # batches do; one 65,536-row set is 1.7 GB a tensor
    retaken = RETAKEN_TRACES[0]
    p99 = times(512, 8, bf16, "flash_kernel_mma")
    bulk = times(B4R_SLICE, 2, bf16, "flash_kernel_mma")
    p99_f32 = times(512, 8, f32, "flash_kernel_f32")
    for name, r in (("tensor-core route, serve_p99 batch 512, bf16", p99),
                    (f"tensor-core route, serve_bulk slice {B4R_SLICE}, bf16", bulk),
                    ("f32 route, batch 512, f32", p99_f32)):
        log(f"flash_attention {name}, (B, 200, 2, 32): kernel {r['ms']:.4f} ms "
            f"(profiler; one call between events {r['call_ms']:.4f} ms), plain "
            f"{r['plain_ms']:.4f} ms, F.scaled_dot_product_attention "
            f"{r['library_device_ms']:.4f} ms (profiler; one call between events "
            f"{r['library_ms']:.4f} ms); kernel / SDPA {r['vs_library']:.3f}, call / "
            f"call {r['call_vs_library_call']:.3f}; bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}), {100 * r['frac_of_bound']:.1f}% "
            f"of bound")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_mma.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:38",
                launches=None, max_abs_err=max(c["max_abs_err"] for c in checks),
                shape=f"serve_bulk slice, ({B4R_SLICE}, 200, 2, 32) bf16, not causal",
                **{k: bulk[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms", "call_ms", "frac_of_bound",
                                        "vs_library", "library_device_ms",
                                        "call_vs_library_call")},
                serve_p99=p99, checks=len(checks),
                retaken_traces=RETAKEN_TRACES[0] - retaken,
                f32_route=dict(source="src/repro_torch/kernels/csrc/flash_attention.cu",
                               shape="(512, 200, 2, 32) f32, not causal",
                               launches_on_paths=0, **p99_f32))


def check_and_time_adaptive_quant(gen, dev):
    """The unpacked ``adaptive_quant`` kernel against its plain version
    (``core.quantize.adaptive_quantize``) on the card, num_bins 25 and
    ratio 0.5 (the reference's test settings), at the reference's test
    shapes and at bert4rec's item table, 1,000,448 x 64, at 2, 3, 4 and 8
    bits, and on rows at rounding ties (``ties.tie_rows``: quotients on
    half-integers and one ulp either side, where the kernel's window sends
    values to the divide); timed at the table."""
    import torch

    from repro_torch.core.quantize import adaptive_quantize, dequantize
    from repro_torch.kernels.adaptive_quant import ops as aq
    from repro_torch.kernels.adaptive_quant.ties import tie_rows, tie_share

    checks = []
    for rows, dim in ((256, 64), (512, 10), (256, 128), (512, 200), (B4R_ITEMS, 64),
                      (4096, 64), (1024, 200)):
        x = _rows(gen, rows, dim, dev)
        for bits in (2, 3, 4, 8):
            ties = rows in (4096, 1024)
            xin = tie_rows(x, bits) if ties else x
            k = aq.adaptive_quant_cuda(xin, bits=bits, num_bins=25, ratio=0.5)
            p = adaptive_quantize(xin, bits, 25, 0.5)
            torch.cuda.synchronize()
            out = dict(shape=[rows, dim], bits=bits, ties=ties,
                       code_diff_frac=float((k.codes != p.codes).float().mean()),
                       scale_equal=bool(torch.equal(k.scale, p.scale)),
                       zero_equal=bool(torch.equal(k.zero, p.zero)),
                       scale_max_abs=float((k.scale - p.scale).abs().max()),
                       zero_max_abs=float((k.zero - p.zero).abs().max()),
                       max_abs_err=float((dequantize(k) - dequantize(p)).abs().max()))
            if ties:
                out["tie_share"] = tie_share(xin, bits)
                check(out["tie_share"] > 0.02, f"adaptive_quant {out}: rows at ties")
            checks.append(out)
            check(torch.allclose(k.scale, p.scale, rtol=1e-5, atol=1e-7)
                  and torch.allclose(k.zero, p.zero, rtol=1e-5, atol=1e-7),
                  f"adaptive_quant {out}: scale/zero")
            check(out["code_diff_frac"] <= 2e-3, f"adaptive_quant {out}: codes")
    log("adaptive_quant checks: " + json.dumps(checks))

    x = _rows(gen, B4R_ITEMS, 64, dev)
    n_el, n_steps = x.numel(), int(0.5 * 25)
    n_cand = 2 * n_steps + 1
    # bytes: x read once, codes + scale + zero written once. Instructions
    # per value, the per-row and per-candidate scalar work left out. This
    # kernel: for each of the 2*n_steps+1 candidate ranges, max, min (clip),
    # sub, mul (the quotient by the reciprocal), the rounding's two adds,
    # sub and a compare (the window test), mul, add (dequantize), sub, mul,
    # add (the squared error's sum); then min and max of the row, and the
    # final code: max, min, sub, mul, two adds, sub, compare, float to
    # uint8. The earlier kernel's mix (its yardstick, kept beside it): for
    # each candidate max, min, sub, IEEE divide, rint, max, min (clamp), mul,
    # add, sub, mul, add; then min and max, and the final code: max, min,
    # sub, divide, rint, max, min, float to uint8; an IEEE divide is one
    # reciprocal, five f32 fma-pipe instructions and one range check.
    nbytes = n_el * 4 + n_el + 2 * B4R_ITEMS * 4
    per = {"alu": n_cand * 3 + 2 + 3, "fma": n_cand * 10 + 5, "xu": 1}
    per_parent = {"alu": 2 + n_cand * (4 + 1) + 4 + 1, "fma": n_cand * (6 + 5) + 1 + 5,
                  "xu": n_cand * 2 + 3}
    b_ms, b_by = bound(nbytes, {c: n_el * n for c, n in per.items()})
    pb_ms, pb_by = bound(nbytes, {c: n_el * n for c, n in per_parent.items()})
    ms_by_bits, retaken = {}, RETAKEN_TRACES[0]
    for bits in (2, 3, 4, 8):
        ms_by_bits[bits] = kernel_ms(lambda: aq.adaptive_quant_cuda(
            x, bits=bits, num_bins=25, ratio=0.5), "adaptive_quant_kernel", reps=20)
    call = lambda: aq.adaptive_quant_cuda(x, bits=4, num_bins=25, ratio=0.5)
    r = dict(ms=ms_by_bits[4], call_ms=time_ms(call, reps=20),
             plain_ms=time_ms(lambda: adaptive_quantize(x, 4, 25, 0.5), reps=5),
             bound_ms=b_ms, bound_by=b_by)
    del x
    torch.cuda.empty_cache()
    log(f"adaptive_quant ({B4R_ITEMS}, 64), num_bins 25, ratio 0.5: kernel "
        f"{json.dumps({b: round(t, 4) for b, t in ms_by_bits.items()})} ms by bits "
        f"(profiler); 4-bit call between events {r['call_ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {b_ms / r['ms']:.1%} of "
        f"it; the earlier kernel's mix: {pb_ms:.4f} ms, {pb_by})")
    return dict(name="adaptive_quant", route="cuda",
                source="src/repro_torch/kernels/csrc/adaptive_quant.cu",
                replaces="src/repro/kernels/adaptive_quant/kernel.py:61",
                launches=None, max_abs_err=max(c["max_abs_err"] for c in checks),
                shape=f"({B4R_ITEMS}, 64) f32, 4-bit, num_bins 25, ratio 0.5",
                library_ms=None, ms_by_bits=ms_by_bits, checks=len(checks),
                max_code_diff_frac=max(c["code_diff_frac"] for c in checks),
                bound_ms_earlier_mix=pb_ms, bound_by_earlier_mix=pb_by,
                retaken_traces=RETAKEN_TRACES[0] - retaken,
                **{k: r[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by")})


# ------------------------------------------------------------------ phase 3


def phase_main_path(kernels, root):
    """Train, fail, restore and save again into ``root``; returns the
    resumed Trainer, still open, for the serve phase."""
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
    record_launches(kernels, "dlrm-rm2 train", launches)
    return tr2


# ------------------------------------------------------------------ phase 4


def phase_serve(kernels, root, trainer, device="cuda", reduced=False,
                p99_batches=200, bulk_batches=4):
    """Serve dlrm-rm2 from the chain in ``root`` (phase 3's store), then
    follow it with a subscriber while ``trainer`` (phase 3's resumed
    Trainer, still open) saves once more."""
    import numpy as np

    from repro_torch.configs import get_cell
    from repro_torch.core import CheckNRunManager, CheckpointConfig, LocalFSStore
    from repro_torch.core import checkpoint as cp
    from repro_torch.core import manifest as mf
    from repro_torch.core import range_reader as rr
    from repro_torch.data.cells import batch_for_cell
    from repro_torch.kernels.dot_interaction import ops as di
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.models import dlrm
    from repro_torch.serve import CheckpointSubscriber, EmbeddingServer
    from repro_torch.train.loop import batch_to_device
    from repro_torch.train.state import restore_train_state

    cap = None if reduced else VOCAB_CAP
    p99 = get_cell("dlrm-rm2", "serve_p99", reduced=reduced, device=device, vocab_cap=cap)
    bulk = get_cell("dlrm-rm2", "serve_bulk", reduced=reduced, device=device, vocab_cap=cap)
    n_fields = p99.cfg.n_sparse
    batches = [batch_for_cell(p99, 50_000 + i) for i in range(p99_batches)]
    bulk_np = [batch_for_cell(bulk, 60_000 + i) for i in range(bulk_batches)]
    store = LocalFSStore(root)
    head = mf.latest_step(store)

    def answer(bundle, params, batch):
        """One request batch: host arrays in, host probabilities out."""
        return bundle.step_fn(params, batch_to_device(batch, bundle.device)).cpu().numpy()

    # (a) restore the newest chain, then serve request batches of 512
    eb.LAUNCHES.reset()
    di.LAUNCHES.reset()
    t0 = time.monotonic()
    mgr = CheckNRunManager(store, CheckpointConfig(device=device))
    restored = mgr.restore()
    mgr.close()
    params = restore_train_state(p99.make_state(), restored, p99.tracked).params
    first = answer(p99, params, batches[0])
    first_s = time.monotonic() - t0
    check(restored.step == head and np.isfinite(first).all(),
          f"restored the newest step {restored.step} == {head} and answered")
    lat = []
    for b in batches[1:]:
        t1 = time.monotonic()
        probs = answer(p99, params, b)
        lat.append((time.monotonic() - t1) * 1e3)
        check(probs.shape == (b["dense"].shape[0],) and np.isfinite(probs).all()
              and ((probs >= 0) & (probs <= 1)).all(),
              "serve_p99 probabilities finite, in [0, 1], one per request")
    lat.sort()
    p50, p99_ms = lat[len(lat) // 2], lat[int(len(lat) * 0.99)]
    # where a request batch's time goes: device time by kernel group from a
    # profiler trace of 20 batches, against their wall time (which the
    # profiler itself lengthens)
    from torch.profiler import ProfilerActivity, profile

    traced = batches[1:21]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.monotonic()
        for b in traced:
            answer(p99, params, b)
        traced_ms = (time.monotonic() - t1) * 1e3 / len(traced)
    dev_ms, _ = _device_split(prof, len(traced), {
        g: (g,) for g in ("embedding_bag", "dot_interaction", "gemm", "memcpy")})
    busy_ms = sum(dev_ms.values())
    check(dev_ms.get("embedding_bag", 0) > 0 and dev_ms.get("dot_interaction", 0) > 0,
          f"the traced serve batches ran both kernels: {dev_ms}")
    log(f"serve_p99 trace, per batch: wall {traced_ms:.3f} ms under the profiler, "
        f"device busy {busy_ms:.3f} ms ({json.dumps({k: round(v, 4) for k, v in dev_ms.items()})}), "
        f"device idle share {1 - busy_ms / traced_ms:.3f}")
    # (b) bulk scoring, timed after one warm-up batch (the allocator's
    # first blocks of this size)
    for i, b in enumerate(bulk_np):
        if i == 1:
            t1 = time.monotonic()
        probs = answer(bulk, params, b)
        check(probs.shape == (b["dense"].shape[0],) and np.isfinite(probs).all(),
              "serve_bulk probabilities finite, one per row")
    bulk_s = time.monotonic() - t1
    rows_s = sum(b["dense"].shape[0] for b in bulk_np[1:]) / bulk_s
    # (c) every batch went through both kernels, one launch each: the
    # lookup takes all fields in one
    n = p99_batches + len(traced) + bulk_batches
    launches = {"embedding_bag": eb.LAUNCHES.count, "dot_interaction": di.LAUNCHES.count}
    check(launches == {"embedding_bag": n, "dot_interaction": n},
          f"serve launches {launches} == one each for {n} batches of {n_fields} fields")
    log(f"serve: restore of step {restored.step} (chain {restored.chain_len}) to "
        f"the first answer {first_s:.2f} s; serve_p99 {p99_batches} batches of "
        f"{batches[0]['dense'].shape[0]}: p50 {p50:.3f} ms, p99 {p99_ms:.3f} ms per "
        f"batch (host arrays in, host probabilities out); serve_bulk "
        f"{bulk_batches - 1} batches of {bulk_np[0]['dense'].shape[0]} after one: "
        f"{bulk_s:.3f} s, "
        f"{rows_s:.0f} rows/s; launches {launches}")
    # (d) the kernel path against the plain versions on the card, one batch
    b = batch_to_device(batches[0], p99.device)
    k = dlrm.serve(params, b, p99.cfg)
    p = dlrm.serve(params, b, p99.cfg, bag=eb.embedding_bag_fields_torch,
                   interact=di.dot_interaction_torch)
    serve_err = float((k - p).abs().max())
    # bf16 model: equal embeddings (H = 1) and f32 dots that differ in the
    # last bits can still round to neighbouring bf16 values before the top
    # MLP; 1e-2 on a probability is far above that and far below a wrong
    # lookup or pair order
    check(serve_err <= 1e-2, f"kernel path vs plain path probabilities: {serve_err}")
    log(f"serve: kernel path vs plain path on one batch, max |dp| {serve_err:.3g}")
    # (e) a subscriber follows the store: bit-equal to restore(), then one delta
    sub = CheckpointSubscriber(LocalFSStore(root), EmbeddingServer())
    t1 = time.monotonic()
    check(sub.poll_once(), f"subscriber full sync: {sub.health}")
    sync_s = time.monotonic() - t1
    with sub.server.pinned() as v:
        check(v.step == head, f"subscriber at step {v.step}")
        for name, want in restored.tables.items():
            check(np.array_equal(v.tables()[name], want),
                  f"{name}: subscriber table == restore() bit for bit")
    sync_bytes = sub.refresh_bytes_total
    trainer.run(2)
    trainer.manager.wait()
    nxt = mf.latest_step(store)
    check(nxt == head + 2, f"one more save: step {nxt}")
    t1 = time.monotonic()
    check(sub.poll_once(), f"subscriber delta poll: {sub.health}")
    catchup_s = time.monotonic() - t1
    delta_bytes = sub.refresh_bytes_total - sync_bytes
    man = mf.load(store, nxt)
    check(sub.incremental_refreshes_total == 1 and sub.full_syncs_total == 1,
          f"the second poll applied a delta: {sub.metrics()}")
    check(delta_bytes == rr.plan_ranges([man]).nbytes,
          f"delta poll fetched {delta_bytes} B == step {nxt}'s chunks and dense "
          f"{rr.plan_ranges([man]).nbytes} B")
    rows = 0
    with sub.server.pinned() as v:
        check(v.step == nxt, f"subscriber at step {v.step}")
        for name, rec in man.tables.items():
            for ch in rec.chunks:
                idx, vals, _ = cp.decode_chunk(nxt, name, rec, ch, store.get(ch.key))
                check(np.array_equal(v.tables()[name][idx], vals),
                      f"{name}: step {nxt}'s rows applied")
                rows += len(idx)
    log(f"subscriber: full sync of step {head} {sync_s:.2f} s, {sync_bytes} B, "
        f"tables bit-equal to restore(); step {nxt} ({man.kind}) caught up by its "
        f"delta alone in {catchup_s:.3f} s, {delta_bytes} B, {rows} rows")
    record_launches(kernels, "dlrm-rm2 serve", launches)
    return dict(first_answer_s=first_s, p50_ms=p50, p99_ms=p99_ms, bulk_rows_s=rows_s,
                traced_ms=traced_ms, device_busy_ms=busy_ms,
                serve_max_abs_dp=serve_err, sync_s=sync_s, sync_bytes=sync_bytes,
                catchup_s=catchup_s, catchup_bytes=delta_bytes)


# ------------------------------------------------------------------ phase 5


def phase_bert4rec(kernels, root, device="cuda", reduced=False, p99_batches=200,
                   bulk_batches=4):
    """bert4rec at full width: train through saves and a restore into
    ``root``, serve from that chain through ``flash_attention``, and run the
    ``adaptive_quant`` op on the trained item table. ``device`` and
    ``reduced`` let the phase be rehearsed on the CPU at the reduced cell."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_cell
    from repro_torch.core import (CheckNRunManager, CheckpointConfig,
                                  LocalFSStore, PAPER_DEFAULTS, scan_store)
    from repro_torch.core import manifest as mf
    from repro_torch.core.quantize import dequantize, mean_l2_loss, uniform_quantize
    from repro_torch.data.cells import batch_for_cell
    from repro_torch.kernels.adaptive_quant import ops as aq
    from repro_torch.kernels.chunk_hash import ops as ch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import bert4rec
    from repro_torch.train.loop import Trainer, TrainerConfig, batch_to_device
    from repro_torch.train.state import restore_train_state

    bundle = get_cell("bert4rec", "train_batch", reduced=reduced, device=device)
    cfg = bundle.cfg
    n_items = cfg.n_items
    check(reduced or cfg.n_items == B4R_ITEMS and cfg.embed_dim == 64 and cfg.n_blocks == 2
          and cfg.n_heads == 2 and cfg.seq_len == 200 and cfg.d_ff == 256
          and cfg.compute_dtype == torch.bfloat16
          and bundle.make_inputs()["items"].shape == (65536, 200)
          and bundle.make_inputs()["neg_ids"].shape == (256,),
          "bert4rec at full width")
    log(f"bert4rec full width: {cfg.n_items} items x {cfg.embed_dim} "
        f"({cfg.n_items * cfg.embed_dim * 4 / 1e6:.1f} MB f32), {cfg.n_blocks} blocks "
        f"of {cfg.n_heads} heads, seq {cfg.seq_len}, d_ff {cfg.d_ff}, batch 65536 "
        f"in 4 micro-batches, 256 shared negatives")

    # (a) train: steps 1-4 with saves at 2 (full) and 4 (incremental)
    step_s = []
    step_fn = bundle.step_fn

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t1 = time.monotonic()
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t1)
        return out

    bundle.step_fn = timed_step
    ckpt = CheckpointConfig(interval_batches=2, policy="intermittent",
                            quant=PAPER_DEFAULTS[4], keep_latest=10, device=device)
    store = LocalFSStore(root)
    for c in (aq.LAUNCHES, ch.LAUNCHES):
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    tr = Trainer(bundle, store, ckpt, TrainerConfig(total_steps=4, log_every=1))
    check(tr.init_or_restore() == 0, "bert4rec fresh start")
    tr.run(4)
    run_s = time.monotonic() - t0
    tr.manager.wait()
    wait_s = time.monotonic() - t0 - run_s
    peak_train_gb = torch.cuda.max_memory_allocated() / 1e9
    live = tr.state.params["tables"]["item_0"].cpu().numpy()
    tr.close()
    steps = mf.list_steps(store)
    check(steps == [2, 4], f"bert4rec committed steps {steps}")
    saves = {}
    for s in steps:
        man = mf.load(store, s)
        recs = man.tables["item_0"].chunks
        check(all(c.hash32 is not None for c in recs), f"hash32 on step {s}")
        saves[s] = dict(kind=man.kind, chunks=len(recs), nbytes=man.nbytes_total,
                        rows=sum(c.n_rows for c in recs))
    check(saves[2]["kind"] == "full" and saves[2]["rows"] == n_items,
          f"the first save is full: {saves[2]}")
    check(saves[4]["kind"] != "full" and 0 < saves[4]["rows"] < n_items,
          f"the second save is incremental: {saves[4]}")
    n_chunks = sum(v["chunks"] for v in saves.values())
    launches = {"quant_pack": aq.LAUNCHES.count, "chunk_hash": ch.LAUNCHES.count}
    check(launches == {"quant_pack": n_chunks, "chunk_hash": n_chunks},
          f"bert4rec save launches {launches} == chunks written {n_chunks}")
    check(all(math.isfinite(h["loss"]) for h in tr.history), "bert4rec finite losses")
    log(f"bert4rec train: step times {[round(t, 3) for t in step_s]} s; stalls "
        f"{[round(t, 3) for t in tr.stall_times]} s; init + 4 steps + 2 snapshots "
        f"{run_s:.2f} s, then the last save {wait_s:.2f} s; peak device memory "
        f"{peak_train_gb:.2f} GB; saves {json.dumps(saves)} (incremental row share "
        f"{saves[4]['rows'] / n_items:.4f}); losses "
        f"{[round(h['loss'], 5) for h in tr.history]}; accuracy "
        f"{[round(h['accuracy'], 5) for h in tr.history]}")

    # (b) restore, resume, one more save (step 6) from the restored state
    t0 = time.monotonic()
    rs = CheckNRunManager(LocalFSStore(root), ckpt).restore()
    restore_s = time.monotonic() - t0
    check(rs.step == 4 and rs.chain_len == 2, f"restored step {rs.step}, chain {rs.chain_len}")
    rel = float(np.abs(rs.tables["item_0"] - live).mean() / np.abs(live).mean())
    check(0 < rel < 0.1, f"4-bit restore error {rel} within the quantization bound")
    tr2 = Trainer(bundle, LocalFSStore(root), ckpt, TrainerConfig(total_steps=2, log_every=1))
    check(tr2.init_or_restore() == 4, "bert4rec resume at step 4")
    check(torch.equal(tr2.state.params["tables"]["item_0"].cpu(),
                      torch.from_numpy(rs.tables["item_0"])),
          "Trainer restore == manager.restore()")
    tr2.run(2)
    tr2.manager.wait()
    # where a training step's device time goes: one more step, traced,
    # its result dropped
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.monotonic()
        step_fn(tr2.state, batch_to_device(batch_for_cell(bundle, 6), bundle.device))
        torch.cuda.synchronize()
        traced_step_s = time.monotonic() - t1
    step_split, step_top = _device_split(prof, 1, {
        "gemm": ("gemm", "nvjet", "xmma"), "memcpy": ("memcpy",)})
    log(f"bert4rec traced step: wall {traced_step_s:.3f} s under the profiler, device "
        f"busy {sum(step_split.values()) / 1e3:.3f} s "
        f"({json.dumps({k: round(v, 1) for k, v in step_split.items()})} ms); top "
        f"kernels (ms): {json.dumps(step_top)}")
    man6 = mf.load(store, 6)
    n6 = len(man6.tables["item_0"].chunks)
    launches = {"quant_pack": aq.LAUNCHES.count, "chunk_hash": ch.LAUNCHES.count}
    check(launches == {"quant_pack": n_chunks + n6, "chunk_hash": n_chunks + n6},
          f"launches {launches} == chunks written {n_chunks + n6}")
    check(mf.list_steps(store) == [2, 4, 6] and scan_store(LocalFSStore(root)).ok,
          "bert4rec step 6 committed, store scans clean")
    check(all(math.isfinite(h["loss"]) for h in tr2.history), "finite losses after restore")
    trained = tr2.state.params["tables"]["item_0"]
    tr2.close()
    record_launches(kernels, "bert4rec train", launches)
    log(f"bert4rec restore of step 4 (chain 2) {restore_s:.2f} s, mean rel err "
        f"{rel:.5f}; resumed losses {[round(h['loss'], 5) for h in tr2.history]}; "
        f"step-6 save {man6.kind}, {n6} chunks, {man6.nbytes_total} B")

    # (c) serve from the chain: restore to the first answer, p99 batches,
    # a trace, bulk batches
    p99 = get_cell("bert4rec", "serve_p99", reduced=reduced, device=device)
    bulk = get_cell("bert4rec", "serve_bulk", reduced=reduced, device=device)
    n_p99 = p99.make_inputs()["items"].shape[0]
    n_bulk = bulk.make_inputs()["items"].shape[0]
    batches = [batch_for_cell(p99, 50_000 + i) for i in range(p99_batches)]
    bulk_np = [batch_for_cell(bulk, 60_000 + i) for i in range(bulk_batches)]

    def answer(bnd, params, batch):
        """One request batch: host arrays in, host scores out."""
        return bnd.step_fn(params, batch_to_device(batch, bnd.device)).cpu().numpy()

    fa.MMA_LAUNCHES.reset()
    fa.SIMT_LAUNCHES.reset()
    aq.ADAPTIVE_QUANT_LAUNCHES.reset()
    t0 = time.monotonic()
    mgr = CheckNRunManager(LocalFSStore(root), CheckpointConfig(device=device))
    restored = mgr.restore()
    mgr.close()
    params = restore_train_state(p99.make_state(), restored, p99.tracked).params
    first = answer(p99, params, batches[0])
    first_s = time.monotonic() - t0
    check(restored.step == 6 and first.shape == (n_p99, 100) and np.isfinite(first).all(),
          f"served from step {restored.step}: {first.shape}")
    lat = []
    for b in batches[1:]:
        t1 = time.monotonic()
        scores = answer(p99, params, b)
        lat.append((time.monotonic() - t1) * 1e3)
        check(scores.shape == (n_p99, 100) and np.isfinite(scores).all(),
              "serve_p99 scores finite, 100 per request")
    lat.sort()
    p50, p99_ms = lat[len(lat) // 2], lat[int(len(lat) * 0.99)]
    traced = batches[1:21]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.monotonic()
        for b in traced:
            answer(p99, params, b)
        traced_ms = (time.monotonic() - t1) * 1e3 / len(traced)
    dev_ms, top = _device_split(prof, len(traced), {
        "flash_attention": ("flash_kernel_mma",), "flash_f32": ("flash_kernel",),
        "gemm": ("gemm", "nvjet", "xmma"), "memcpy": ("memcpy",)})
    busy_ms = sum(dev_ms.values())
    check(dev_ms.get("flash_attention", 0) > 0 and "flash_f32" not in dev_ms,
          f"the traced batches ran flash on the tensor-core route alone: {dev_ms}")
    log(f"bert4rec serve_p99 trace, per batch: wall {traced_ms:.3f} ms under the "
        f"profiler, device busy {busy_ms:.3f} ms "
        f"({json.dumps({k: round(v, 4) for k, v in dev_ms.items()})}), device idle "
        f"share {1 - busy_ms / traced_ms:.3f}; top kernels (ms): {json.dumps(top)}")
    torch.cuda.reset_peak_memory_stats()
    for i, b in enumerate(bulk_np):
        if i == 1:
            t1 = time.monotonic()
        scores = answer(bulk, params, b)
        check(scores.shape == (n_bulk, 100) and np.isfinite(scores).all(),
              "serve_bulk scores finite, 100 per row")
    bulk_s = time.monotonic() - t1
    peak_bulk_gb = torch.cuda.max_memory_allocated() / 1e9
    rows_s = n_bulk * (bulk_batches - 1) / bulk_s
    slices = -(-n_bulk // bulk.cfg.serve_slice_rows)
    n_fwd = p99_batches + len(traced) + slices * bulk_batches
    check(fa.MMA_LAUNCHES.count == 2 * n_fwd and fa.SIMT_LAUNCHES.count == 0,
          f"flash launches {fa.MMA_LAUNCHES.count} on the tensor-core route == 2 "
          f"blocks x {n_fwd} forwards ({p99_batches + len(traced)} p99 batches, "
          f"{bulk_batches} bulk batches of {slices} slices), "
          f"{fa.SIMT_LAUNCHES.count} on the f32 route")
    launches = {"flash_attention": fa.MMA_LAUNCHES.count}
    log(f"bert4rec serve: restore of step {restored.step} (chain {restored.chain_len}) "
        f"to the first answer {first_s:.2f} s; serve_p99 {p99_batches} batches of {n_p99} "
        f"x 100 candidates: p50 {p50:.3f} ms, p99 {p99_ms:.3f} ms per batch (host "
        f"arrays in, host scores out); serve_bulk {bulk_batches - 1} batches of {n_bulk} "
        f"in {slices} slices of {bulk.cfg.serve_slice_rows} after one: {bulk_s:.3f} s, "
        f"{rows_s:.0f} rows/s, peak device memory {peak_bulk_gb:.2f} GB; flash "
        f"launches {launches['flash_attention']}")

    # (d) the kernel path against the plain version, and slices against the
    # whole batch, on one p99 batch
    b = batch_to_device(batches[0], p99.device)
    k_scores = bert4rec.serve(params, b, p99.cfg)
    p_scores = bert4rec.serve(params, b, p99.cfg, attention=fa.flash_attention_torch)
    s_scores = bert4rec.serve(params, b, dataclasses.replace(p99.cfg, serve_slice_rows=128))
    serve_err = float((k_scores - p_scores).abs().max())
    slice_err = float((k_scores - s_scores).abs().max())
    scale = float(p_scores.abs().max())
    # bf16 model: attention outputs one bf16 step apart pass through two
    # blocks' bf16 GEMMs and layernorms; 5e-2 on a score is far above that
    # and far below a wrong mask, head or key
    check(serve_err <= 5e-2, f"kernel vs plain scores: max |ds| {serve_err}")
    check(slice_err <= 5e-2, f"sliced vs whole scores: max |ds| {slice_err}")
    log(f"bert4rec serve: kernel vs plain attention on one batch, max |ds| "
        f"{serve_err:.3g} (scores up to {scale:.3g}); slices of 128 vs the whole "
        f"batch, max |ds| {slice_err:.3g}")

    # (e) the adaptive_quant op on the trained item table
    l2 = {}
    for bits in (2, 3, 4, 8):
        q = aq.adaptive_quant(trained, bits=bits, num_bins=25, ratio=0.5)
        l_ad = float(mean_l2_loss(trained, dequantize(q)))
        l_uni = float(mean_l2_loss(trained, dequantize(uniform_quantize(trained, bits))))
        l2[bits] = dict(adaptive=l_ad, uniform=l_uni)
        # the search starts from the full range and keeps a range only if
        # it lowers the row's error, so adaptive <= uniform row by row; at
        # 2-4 bits it must lower it (the paper's Fig. 6)
        check(l_ad < l_uni if bits <= 4 else l_ad <= l_uni,
              f"{bits}-bit adaptive L2 {l_ad} vs uniform {l_uni}")
    launches["adaptive_quant"] = aq.ADAPTIVE_QUANT_LAUNCHES.count
    check(launches["adaptive_quant"] == 4, f"adaptive_quant launches {launches}")
    log(f"adaptive_quant on the trained item table ({tuple(trained.shape)}), num_bins "
        f"25, ratio 0.5, mean row L2: {json.dumps(l2)}")
    record_launches(kernels, "bert4rec serve", launches)
    return dict(step_s=step_s, peak_train_gb=peak_train_gb, first_answer_s=first_s,
                p50_ms=p50, p99_ms=p99_ms, bulk_rows_s=rows_s, peak_bulk_gb=peak_bulk_gb,
                serve_max_abs_ds=serve_err, l2=l2)


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
        root = tempfile.mkdtemp(prefix="cnr-chip-smoke-")
        trainer = None
        try:
            trainer = phase_main_path(kernels, root)
            phase_serve(kernels, root, trainer)
        finally:
            if trainer is not None:
                trainer.close()
            shutil.rmtree(root, ignore_errors=True)
        root = tempfile.mkdtemp(prefix="cnr-chip-smoke-b4r-")
        try:
            phase_bert4rec(kernels, root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        for k in kernels:
            check(k["launches"] > 0, f"{k['name']} ran on its path")
    log(f"total {time.monotonic() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
