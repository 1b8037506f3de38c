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
     the main paths' shapes (the quantizers also on rows of 1,100 to 8,192
     values, their wide route), and timed beside its plain version and, where
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
     Then retrieval (``retrieval_cand``) on the restored params: one user
     against 1,000,000 candidates a request, 30 requests after a warm-up,
     each one ``embedding_bag`` launch (the user's 26 fields) and no
     ``dot_interaction`` launch; the kernel path against the plain lookup.
  4b. sharded: dlrm-rm2 at phase 3's width and cap, saving through 4
     simulated hosts (per-host shard writers, threads of this process on
     the one card, and a coordinator-less two-phase commit): saves at
     steps 2 (full, 188 chunks), 4 and 6; the loss of host 1 at step 7,
     recovered ``exact`` (survivors from the step-6 boundary snapshot,
     host 1's shard from the store); a save at 8; the loss of host 2 at
     step 9, recovered ``cpr`` (only its rows roll back); a save at 10; a
     read of host 1's shard at step 6 under 3 hosts. Each save's
     ``quant_pack`` and ``chunk_hash`` launches equal its chunks; then
     whether one training step repeated from the same state on the card
     gives the same bits.
  4c. host processes: dlrm-rm2 at the same width and cap, saving through 4
     OS processes (``multiprocess=True``; each its own CUDA context, its
     chunks quantized and hashed by the kernels in that process, its launch
     counts reported to the launcher) over an object server
     (``python -m repro_torch.core.object_server``) on 127.0.0.1, reached
     only through its ``http://`` URI: a full and an incremental save, each
     byte for byte an in-process 4-host save of the same snapshot; a host
     killed mid-save (``MultiprocessSaveError``, the last step restores); a
     subscriber over the URI bit-equal to ``restore()``; the drill: the
     next step saved by 4 processes with host 1 SIGKILLed mid-chunks, then
     ``RecoverySupervisor.respawn`` of host 1 alone committing it; ``ckpt
     scan``, ``ckpt recover --host 1 --device cuda`` and ``ckpt subscribe``
     over the URI. Prints each save's wall time and its slowest host's,
     the spill's seconds and bytes, each process's start-up, the bytes on
     the wire.

  5. bert4rec at full width (1,000,448 items, dim 64, 2 blocks of 2 heads
     of 32, seq 200, d_ff 256, bf16 compute): the Trainer at batch 65,536
     (4 micro-batches) through 4-bit adaptive saves, a restore and one more
     save (``quant_pack`` and ``chunk_hash``); serving from that chain,
     ``serve_p99`` (batch 512, 100 candidates each, 200 batches and a
     20-batch trace) and ``serve_bulk`` (262,144 rows in slices of 65,536,
     a warm-up batch and 3 timed), both blocks attending through
     ``flash_attention``'s tensor-core route (bf16), every launch of it; the scores through the kernel against the plain
     version; and the ``adaptive_quant`` op on the trained item table at 2,
     3, 4 and 8 bits, its L2 error against uniform quantization's; then
     retrieval: one sequence against 1,000,000 candidates a request, 30
     requests after a warm-up, 2 tensor-core ``flash_attention`` launches
     each, against the plain attention and against ``serve`` on the first
     100 candidates.
  6. xdeepfm at full width, no cut (39 fields; 22,451,200 rows at dim 10
     and as many at dim 1, 0.99 GB f32; CIN 200-200-200, MLP 400-400, bf16
     compute): the Trainer at batch 65,536 through 4-bit adaptive saves
     every 2 steps (a full save is 752 chunks, 376 a table family, each one
     ``quant_pack`` and one ``chunk_hash`` launch, the dim-1 ones on the
     kernel's masked route), a failure at 7, a restore (``emb_*`` within the
     4-bit bar, every ``lin_*`` value its fp16 rounding), a save at 8; a
     traced step and its peak memory; serving from that chain, serve_p99
     and serve_bulk, two ``embedding_bag`` launches a forward (39 fields at
     D = 10, 39 at D = 1: the scalar route), probabilities bit-equal to the
     plain lookups'; retrieval, one user against 1,000,000 candidates
     (999,424 scored: whole chunks of 8,192), four launches a request.
  7. mind at full width, no cut (1,000,448 items x 64, 4 interests, 3
     routing iterations, history 50, 1,024 shared negatives): saves at 2
     (full, 16 chunks) and 4, a restore, a save at 6; serve_p99,
     serve_bulk and retrieval (1,000,000 candidates, the max over
     interests), no kernel in a forward (the reference's lookups are
     ``jnp.take``).
  8. k-means: the Fig. 5 orderings at (1,000,448, 64), 3 bits, 8 blocks,
     on the reference test's skewed rows (the adaptive arm one
     ``adaptive_quant`` launch); the card against the CPU on 4,096 rows;
     each quantizer timed; every method's L2 on mind's trained table.
  9. the CPR-versus-full loss experiment on its reduced dlrm-rm2 cell on
     the card: within its bound, a partial recovery, fewer bytes read than
     a full restore.
  10. dimenet at full width (6 blocks, hidden 128, 8 bilinear, 7 x 6
     bases): ``molecule`` (128 molecules of 30 atoms) through 4-bit saves
     of the 95 x 128 species table every 2 steps, a failure at step 5, a
     restore and a save at 6, energies served from the chain against the
     live model; ``minibatch_lg`` at its full shape (169,984 nodes,
     168,960 edges, 337,920 triplets) through dense-only saves, a restore,
     logits bit-equal to the live model's; ``full_graph_sm``, 2 steps; a
     traced step of each trained cell. ``ogb_products`` does not fit one
     card (its reckoning is logged).
  11. qwen2-0.5b at full width: ``train_4k`` at global batch 2 of 256
     (sequence 4,096) through 4-bit ``tok_emb`` saves, a failure at 5, a
     restore, a save at 6; ``prefill_32k`` at batch 4 of 32 from the
     restored params, one tensor-core ``flash_attention`` launch a layer
     (one layer held against the plain version per query row, timed
     beside SDPA);
     ``decode_32k`` at its full shape (a 51.5 GB cache made on the card),
     8 steps; decode against a full forward, bf16, within 3e-2 of the logit
     scale.
  12. nemotron-4-15b at full width and depth (15.6 B parameters, 62.5 GB
     f32, made on the card; not trained): prefill at 1 x 4,096 through
     ``flash_attention`` (one layer held as in 11), 16 decode steps
     against a 32,768-position cache, then ``tok_emb`` (256,000 x 6,144)
     saved at 4-bit adaptive through ``quant_pack``'s wide route (4
     chunks) and restored.
  13-15. olmoe-1b-7b, minicpm3-4b and dbrx-132b at full width, depth cut
     (see each phase's docstring).
  16. the dry run (``python -m repro_torch.launch.dryrun --all``, in this
     process) on the 16 x 16 and 2 x 16 x 16 production meshes: every
     cell's per-device bytes, built on the meta device, against the card's
     memory, and equal to the reference's (``tests/dryrun_reference_bytes
     .json``); the collectives counted for dimenet's cells, the recsys and
     LM train cells and the expert-parallel serving cells equal
     ``tests/dryrun_collectives.json``, null elsewhere; nothing allocated
     on the card.
  17. the mesh: 4 processes on the one card, a 2 x 2 (data, model) mesh
     over a gloo group at 127.0.0.1. Expert parallelism: one olmoe-1b-7b
     MoE layer at full width (d 2,048, 64 experts top-8, d_ff 1,024) in
     bf16 on 4,096 tokens a rank; the output held to the dense dispatch of
     this process where nothing drops, and at the default capacity (φ = 2)
     to a plain emulation of the capacity rule. Then the sharded DimeNet
     at full width on ``minibatch_lg``'s full shape (169,984 nodes,
     168,960 edges, 337,920 triplets): the ranks' rows and summed
     gradients held to rank 0's ``forward_flat`` of the batch with the
     locality clamp applied; training through ``launch/train.py --mesh
     2x2`` with dense-only saves, a failure and a resume from the one
     chain, the ranks' parameters bit-equal after every step and the
     restore; one step's recorded collectives equal to the dry run's count.
     Then the row-sharded tables (``recsys_worker``): dlrm-rm2 (cap 2^20),
     xdeepfm, mind and bert4rec at full width on ``train_batch`` (xdeepfm
     at 32,768 and bert4rec at 8,192: ``RS_BATCH``) and dimenet's
     ``molecule``, one mesh step each held to rank 0's one-process step of
     the same state (loss, tables, accumulators, touched masks), its bytes
     equal to the dry run's count on 2 x 2, its collectives' share of the
     step; then dlrm-rm2 through ``launch/train.py --mesh 2x2`` with 4-bit
     saves gathered to rank 0 (``quant_pack`` and ``chunk_hash`` there), a
     failure and a resume whose range-read rows are held to rank 0's whole
     restore. Then the LM train cells (``lm_worker``), tensor- and
     sequence-parallel at full width and sequence 4,096, depth and batch
     cut (``LM_CELLS``): qwen2-0.5b and minicpm3-4b on 2 x 2,
     nemotron-4-15b and dbrx-132b on 1 x 4, olmoe-1b-7b on 2 x 2, one mesh
     step each held to rank 0's one-process loss and gradients of the same
     parameters and batch (loss, every leaf's |gradient|, touched masks;
     an MoE routed as the mesh routed, the routing held apart), its bytes
     equal to the dry run's count, its collectives' share, the peak a
     rank; then
     qwen2-0.5b (2 layers) and olmoe-1b-7b (1 layer) through
     ``launch/train.py --mesh 2x2`` with 4-bit saves gathered to rank 0, a
     failure and a resume whose range-read rows (``tok_emb``'s and the
     expert blocks') are held to rank 0's whole restore.

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
from repro_torch.launch.mesh import HBM_BW as PEAK_BYTES_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as PEAK_BF16_FLOPS  # noqa: E402

SMS = 132
CLOCK_HZ = 67e12 / (SMS * 128 * 2)
LANES_PER_CLOCK = {"fma": 128, "alu": 64, "xu": 16}
ISSUE_PER_CLOCK = 128


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


_T0 = time.monotonic()


def log(msg: str) -> None:
    """Print ``msg`` after the seconds since the script started."""
    print(f"[{time.monotonic() - _T0:7.1f} s] {msg}", flush=True)


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


def kernel_ms(fn, name: str, reps: int = 30, min_events=None):
    """Median device time of the kernels whose name contains ``name``, from
    a ``torch.profiler`` trace of ``reps`` calls of ``fn`` (after warm-up):
    unlike events around a call, it leaves out the host's launch overhead.
    A trace that does not hold one such kernel per call is taken again
    (``_traced``). With ``min_events``, a trace that holds at least that
    many will do (the median is of those it holds), and None says that no
    trace did."""
    import torch

    def matching(prof):
        return [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]

    need = reps if min_events is None else min_events
    prof = _traced(fn, reps, lambda p: need <= len(matching(p)) <= reps,
                   lambda p: f"{len(matching(p))} {name} kernels for {reps} calls",
                   required=min_events is None)
    if prof is None:
        return None
    if len(matching(prof)) < reps:
        log(f"profiler trace held {len(matching(prof))} {name} kernels for {reps} "
            f"calls; their median taken")
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


def _traced(fn, reps, ok, what, attempts=8, required=True):
    """A ``torch.profiler`` trace of ``reps`` calls of ``fn`` (after
    warm-up) of which ``ok(trace)`` holds; ``what(trace)`` says what a
    failed one held. A trace that fails ``ok`` is taken again after a
    pause (the profiler has been seen to drop one event of 20, in one run
    events of three traces in a row, and once to record no device event
    at all); raises if the last of ``attempts`` fails too, or returns None
    if not ``required``. Each retake is counted in ``RETAKEN_TRACES``, which
    a kernel's entry in the result line reports as ``retaken_traces``."""
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
    check(not required, f"profiler trace holds {what(prof)}")
    return None


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
    aq_wide = {f: c for f, c in counts.items() if "adaptive_quant_wide_kernel" in f}
    aq_long = {f: c for f, c in counts.items() if "adaptive_quant_long_kernel" in f}
    check(len(mma) == 4 and all(c["HMMA"] > 0 for c in mma.values()),
          f"dot_interaction's bf16 route issues HMMA: {mma}")
    check(len(simt) == 1 and all(c["HMMA"] == 0 for c in simt.values()),
          f"f32 route: {simt}")
    check(len(aq) == 12 and all(c["FCHK"] <= 1 and c["MUFU.RCP"] < 16 and c["CALL"] > 0
                                for c in aq.values()),
          f"adaptive_quant's kernels divide only out of line: {aq}")
    check(len(aq_wide) == 10 and all(c["FCHK"] <= 1 and c["CALL"] > 0
                                     for c in aq_wide.values()),
          f"adaptive_quant's wide kernels divide only out of line: {aq_wide}")
    check(len(aq_long) == 1 and all(c["FCHK"] <= 1 and c["CALL"] > 0
                                    for c in aq_long.values()),
          f"adaptive_quant's long kernel divides only out of line: {aq_long}")
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
                adaptive_quant_wide=aq_wide, adaptive_quant_long=aq_long,
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
    # cuobjdump and the parse take about 20 s of the host: in a process of
    # their own they overlap the kernel checks (``finish_sass_check``)
    code = (f"import json, sys; sys.path.insert(0, {HERE!r}); import chip_smoke; "
            f"print(json.dumps(chip_smoke.check_sass(sys.argv[1])))")
    sass = subprocess.Popen([sys.executable, "-c", code, build.library()._name],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return card, sass


def finish_sass_check(sass) -> None:
    """Wait for phase 1's ``check_sass`` process; its failure fails the run."""
    out, err = sass.communicate(timeout=600)
    check(sass.returncode == 0, f"check_sass exited {sass.returncode}: {err[-3000:]}")
    log("sass: " + out.strip())


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


def check_quant_pack(x, bits, method, cpu=True):
    """Kernel vs plain version on the card (and, with ``cpu``, the plain
    version on the CPU) for one input. Returns the mismatch figures."""
    import numpy as np
    import torch

    from repro_torch.kernels.adaptive_quant import ops

    nb, ns = ops._resolve_steps(method, bits, None, None)
    k = ops.quant_pack_cuda(x, bits=bits, num_bins=nb, n_steps=ns)
    p = ops.quant_pack_torch(x, bits=bits, num_bins=nb, n_steps=ns)
    c = ops.quant_pack_torch(x.cpu(), bits=bits, num_bins=nb, n_steps=ns) if cpu else p
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
                   p.words.cpu().numpy(), c.words.cpu().numpy())),
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


def _qp_instrs(n_el, n_cand):
    """quant_pack's lane instructions by pipe for ``n_el`` values and
    ``n_cand`` candidate ranges. Per value (the per-row work is left out):
    min, max; for each candidate range of the search: sub, mul, max, min,
    the rounding's two adds (r + 1.5*2^23 - 1.5*2^23), sub, mul, add; the
    final code: max, min, sub, divide, the rounding's two adds, max, min,
    float to uint. An IEEE divide is one reciprocal, five f32 fma-pipe
    instructions and one range check."""
    div = {"xu": 1, "fma": 5, "alu": 1}
    per = {"alu": 2 + 2 * n_cand + 4 + div["alu"],
           "fma": 7 * n_cand + 3 + div["fma"],
           "xu": 1 + div["xu"]}
    return {c: n_el * n for c, n in per.items()}


def _aq_instrs(n_el, n_cand):
    """adaptive_quant's lane instructions by pipe (see
    ``check_and_time_adaptive_quant``)."""
    per = {"alu": n_cand * 3 + 2 + 3, "fma": n_cand * 10 + 5, "xu": 1}
    return {c: n_el * n for c, n in per.items()}


WIDE_DIMS = (1100, 2048, 2560, 6144)  # past one lane group's 1,024: a block a row
LONG_DIMS = (10752, 20001)  # past the wide route's 8,192: the row streamed
LONG_DEVICE_DIM = 60001     # past what shared memory holds: read from device memory


def _wide_kernel(dim):
    """The kernel name a row of ``dim`` values launches past 1,024."""
    return "wide" if dim <= 8192 else "long"


def check_and_time_wide_quant(gen, dev):
    """The quantizers' wide and long routes (rows wider than 1,024 values,
    one block of 256 threads a row; past 8,192 the row streamed from shared
    memory, or past 51,200 from device memory): ``quant_pack`` against its
    plain version at widths 1,100 (not a multiple of 32: rows share words),
    2,048, 2,560 and 6,144 (the LMs' ``tok_emb`` widths), 8,192 (the wide
    route's limit), 10,752 (dbrx's expert rows), 20,001 (odd) and 60,001
    (in device memory), bits 2, 4 and 8, adaptive and uniform (uniform words
    byte-identical, adaptive within the bars); ``adaptive_quant`` likewise
    (num_bins 25, ratio 0.5). Then each timed at 65,536 rows of each width
    but 8,192 and 60,001 (6,144: 1.61 GB f32; 20,001: 5.24 GB), 4-bit
    (``quant_pack`` adaptive as the save path runs it), beside its bound
    and, at 6,144 and 10,752, its plain version."""
    import torch

    from repro_torch.core.quantize import adaptive_quantize, dequantize
    from repro_torch.kernels.adaptive_quant import ops as aq

    qp_checks, aq_checks = [], []
    for dim in WIDE_DIMS + (8192,) + LONG_DIMS + (LONG_DEVICE_DIM,):
        x = _rows(gen, 700, dim, dev)
        for bits in (2, 4, 8):
            for method in ("adaptive", "uniform_asym"):
                qp_checks.append(check_quant_pack(x, bits, method, cpu=False))
            k = aq.adaptive_quant_cuda(x, bits=bits, num_bins=25, ratio=0.5)
            p = adaptive_quantize(x, bits, 25, 0.5)
            out = dict(shape=[700, dim], bits=bits,
                       code_diff_frac=float((k.codes != p.codes).float().mean()),
                       scale_max_abs=float((k.scale - p.scale).abs().max()),
                       zero_max_abs=float((k.zero - p.zero).abs().max()),
                       max_abs_err=float((dequantize(k) - dequantize(p)).abs().max()))
            aq_checks.append(out)
            check(torch.allclose(k.scale, p.scale, rtol=1e-5, atol=1e-7)
                  and torch.allclose(k.zero, p.zero, rtol=1e-5, atol=1e-7)
                  and out["code_diff_frac"] <= 2e-3, f"adaptive_quant wide {out}")
    log("wide and long quant_pack checks: " + json.dumps(qp_checks))
    log("wide and long adaptive_quant checks: " + json.dumps(aq_checks))

    rows = 65536
    nb, ns = aq._resolve_steps("adaptive", 4, None, None)
    n_aq = int(0.5 * 25)
    qp_t, aq_t = {}, {}
    for dim in WIDE_DIMS + LONG_DIMS:
        x = _rows(gen, rows, dim, dev)
        n_el = x.numel()
        words = (n_el * 4 + 31) // 32
        qb, qby = bound(n_el * 4 + words * 4 + 2 * rows * 4, _qp_instrs(n_el, 2 * ns + 1))
        ab, aby = bound(n_el * 5 + 2 * rows * 4, _aq_instrs(n_el, 2 * n_aq + 1))
        route = _wide_kernel(dim)
        # a trace of 10 calls that holds 8 will do: the profiler dropped one
        # event of every trace of one of these kernels in a run
        qp_t[dim] = dict(route=route, ms=kernel_ms(lambda: aq.quant_pack_cuda(
            x, bits=4, num_bins=nb, n_steps=ns), f"quant_pack_{route}_kernel", reps=10,
            min_events=8), bound_ms=qb, bound_by=qby)
        aq_t[dim] = dict(route=route, ms=kernel_ms(lambda: aq.adaptive_quant_cuda(
            x, bits=4, num_bins=25, ratio=0.5), f"adaptive_quant_{route}_kernel", reps=10,
            min_events=8), bound_ms=ab, bound_by=aby)
        check(qp_t[dim]["ms"] and aq_t[dim]["ms"], f"traces of the {route} route at {dim}")
        if dim in (6144, 10752):  # one call each: the plain versions take seconds
            qp_t[dim]["plain_ms"] = time_ms(lambda: aq.quant_pack_torch(
                x, bits=4, num_bins=nb, n_steps=ns), reps=1, warmup=0)
            aq_t[dim]["plain_ms"] = time_ms(lambda: adaptive_quantize(x, 4, 25, 0.5),
                                            reps=1, warmup=0)
        for t in (qp_t[dim], aq_t[dim]):
            t["frac_of_bound"] = t["bound_ms"] / t["ms"]
        del x
        torch.cuda.empty_cache()
    log(f"wide and long routes, {rows} rows, 4-bit: quant_pack (adaptive, num_bins "
        f"{nb}, {ns} steps) {json.dumps(qp_t)}; adaptive_quant (num_bins 25, ratio "
        f"0.5) {json.dumps(aq_t)}")
    summary = lambda checks: dict(
        checks=len(checks),
        widths=list(WIDE_DIMS) + [8192] + list(LONG_DIMS) + [LONG_DEVICE_DIM],
        max_code_diff_frac=max(c["code_diff_frac"] for c in checks),
        max_abs_err=max(c["max_abs_err"] for c in checks))
    return (dict(summary(qp_checks), uniform_words_identical=all(
                c["words_identical"] for c in qp_checks if c["method"] == "uniform_asym"),
                 times_65536_rows=qp_t),
            dict(summary(aq_checks), times_65536_rows=aq_t))


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
    # part-filled (shared memory), and so do xDeepFM's save chunks, (65536,
    # 10) and (65536, 1)
    for rows, dim in ((65536, 64), (1000, 10), (333, 200), (500, 16), (300, 96),
                      (257, 128), (65536, 10), (65536, 1)):
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
    qp_instrs = lambda n_cand: _qp_instrs(n_el, n_cand)
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
    serve_kernels[0]["xdeepfm"] = check_and_time_xdeepfm_lookups(gen, dev)
    b4r_kernels = [check_and_time_flash(gen, dev), check_and_time_adaptive_quant(gen, dev)]
    qp_wide, aq_wide = check_and_time_wide_quant(gen, dev)
    b4r_kernels[1]["wide_route"] = aq_wide
    return [
        dict(name="quant_pack", route="cuda",
             source="src/repro_torch/kernels/csrc/quant_pack.cu",
             replaces="src/repro/kernels/adaptive_quant/kernel.py:206",
             launches=None, max_abs_err=main_cfg["max_abs_err"],
             ms=qp_ms, plain_ms=qp_plain_ms, bound_ms=qp_bound, bound_by=qp_by,
             library_ms=None, call_ms=qp_call_ms, retaken_traces=qp_retaken,
             wide_route=qp_wide,
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

    for B in (1, 512, 262144):  # 1: a retrieval request's user lookup
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


def check_and_time_xdeepfm_lookups(gen, dev):
    """xDeepFM's lookups: its 39 fields in one ``embedding_bag`` launch at
    D = 10 (the ``emb_*`` tables) and D = 1 (``lin_*``), over its real
    vocabularies (22,451,200 rows a family; 10,000,384 at the largest, so
    the kernel's 64-bit row offsets), H = 1: bit-equal to the plain version,
    then timed at serve_p99 (512) and serve_bulk (262,144) beside one
    ``F.embedding_bag`` over the concatenated tables and the plain version.
    Both widths take the kernel's scalar route (D % 4 != 0)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.xdeepfm import XDEEPFM_VOCABS
    from repro_torch.kernels.embedding_bag import ops as eb

    NF = len(XDEEPFM_VOCABS)
    first = torch.tensor([0] + list(itertools.accumulate(XDEEPFM_VOCABS))[:-1],
                         device=dev, dtype=torch.int64)[None, :, None]

    def rand_ids(B):
        ids = torch.stack([torch.randint(0, v, (B, 1), generator=gen, device=dev)
                           for v in XDEEPFM_VOCABS], dim=1).to(torch.int32)
        ids[-1, :, 0] = torch.tensor([v - 1 for v in XDEEPFM_VOCABS], device=dev)
        return ids

    out = {}
    for D in (10, 1):
        tables = [torch.randn((v, D), generator=gen, device=dev) for v in XDEEPFM_VOCABS]
        cat = torch.cat(tables)
        res = {}
        for B in (512, 262144):
            sets = [(tables, rand_ids(B)) for _ in range(64 if B == 512 else 2)]
            k = eb.embedding_bag_fields_cuda(*sets[0])
            equal = bool(torch.equal(k, eb.embedding_bag_fields_torch(*sets[0])))
            check(equal, f"embedding_bag, {NF} fields at D = {D}, batch {B}: not bit-equal")
            lib_sets = [((i.long() + first).view(-1, 1), cat) for _, i in sets]
            lib = _rotating(lambda i, t: F.embedding_bag(i, t, mode="sum"), lib_sets)
            # bytes: each id's row read, the ids, each bag written in bf16
            b_ms, b_by = bound(B * NF * (D * 4 + 4 + D * 2), {"fma": 0})
            res[B] = dict(
                bit_equal=equal,
                ms=kernel_ms(_rotating(eb.embedding_bag_fields_cuda, sets),
                             "embedding_bag_kernel"),
                call_ms=time_ms(_rotating(eb.embedding_bag_fields_cuda, sets)),
                plain_ms=time_ms(_rotating(eb.embedding_bag_fields_torch, sets), reps=10),
                library_ms=time_ms(lib, reps=20), library_device_ms=device_ms(lib),
                bound_ms=b_ms, bound_by=b_by)
            r = res[B]
            log(f"embedding_bag, xdeepfm's {NF} fields at D = {D} in one launch, batch "
                f"{B}: kernel {r['ms']:.4f} ms (profiler; {b_ms / r['ms']:.1%} of the "
                f"bound; one call between events {r['call_ms']:.4f} ms), plain "
                f"{r['plain_ms']:.4f} ms, F.embedding_bag over the concatenated tables "
                f"{r['library_ms']:.4f} ms (device {r['library_device_ms']:.4f} ms), "
                f"bound {b_ms:.5f} ms ({b_by}); bit-equal to the plain version")
        out[f"d{D}"] = dict(serve_bulk=res[262144], serve_p99=res[512])
        del tables, cat
        torch.cuda.empty_cache()
    return out


B4R_ITEMS = 1_000_448  # bert4rec's published catalog, padded to 512


def flash_bound(B, Sq, Sk, Hq, D, itemsize, causal=False, Hkv=None):
    """(ms, "bytes" or "operations") for one attention call: q, k, v read
    once and o written once against the two products' FLOPs (bf16 on the
    tensor cores; f32, which the f32 route keeps, at the 67 TFLOP/s of f32
    FMAs) and the softmax's exps on the 16-lane conversion pipe. Causal
    (Sq == Sk), only the scores on or below the diagonal are needed; with
    ``Hkv`` kv heads, k and v are read per kv head."""
    Hkv = Hq if Hkv is None else Hkv
    scores = B * Hq * (Sq * (Sq + 1) / 2 if causal else Sq * Sk)
    t_bytes = (2 * B * Sq * Hq * D + 2 * B * Sk * Hkv * D) * itemsize / PEAK_BYTES_S * 1e3
    peak = PEAK_BF16_FLOPS if itemsize == 2 else 67e12
    t_mma = 4.0 * scores * D / peak * 1e3
    t_exp = scores / (LANES_PER_CLOCK["xu"] * SMS * CLOCK_HZ) * 1e3
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
    # batch 1: a retrieval request's encode (a grid of 2 blocks)
    shapes += [(b, 200, 200, 2, 2, 32, c, dt) for b in (1, 512, B4R_SLICE)
               for c in (False, True) for dt in (bf16, f32)]
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


def _collect_saves(manager) -> list:
    """Keep every save ``manager`` takes (``Trainer.checkpoint`` drops its
    future) as ``[future, submitted, done]``: the ``SaveResult`` carries
    the pipelines' stats (a single-host ``wall_s`` is its pipeline's alone),
    and done − submitted is the whole save, row selection to commit and
    retention (the writer thread is idle at submission: the Trainer waits
    for the previous save first)."""
    saves = []
    save = manager.save

    def keep(snap, block=False):
        entry = [None, time.monotonic(), None]
        saves.append(entry)
        entry[0] = save(snap, block)
        entry[0].add_done_callback(lambda _: entry.__setitem__(2, time.monotonic()))
        return entry[0]

    manager.save = keep
    return saves


def _save_walls_mp(saves):
    """(whole-save seconds, slowest host process's seconds from spawn to
    exit, seconds the trainer waited) of each kept multiprocess save. A
    save submitted while the one before was still writing waits for it
    (the non-overlap rule, which stalls training): it is timed from that
    one's end, and the wait is reported."""
    out, prev_done = [], 0.0
    for entry in saves:
        st = entry[0].result().pipeline_stats
        while entry[2] is None:
            time.sleep(0.001)
        out.append((round(entry[2] - max(entry[1], prev_done), 3),
                    round(max(h["proc_wall_s"] for h in st["per_host"]), 3),
                    round(max(0.0, prev_done - entry[1]), 3)))
        prev_done = entry[2]
    return out


def _save_walls(saves):
    """(whole-save seconds, pipeline seconds) of each kept save: for a
    sharded save the pipeline figure is its slowest host's."""
    out = []
    for entry in saves:
        st = entry[0].result().pipeline_stats
        while entry[2] is None:  # the done callback runs just after result()
            time.sleep(0.001)
        pipe = max(h["wall_s"] for h in st["per_host"]) if "per_host" in st else st["wall_s"]
        out.append((round(entry[2] - entry[1], 3), round(pipe, 3)))
    return out


def phase_main_path(kernels, root, figures=None):
    """Train, fail, restore and save again into ``root``; returns the
    resumed Trainer, still open, for the serve phase. ``figures``, when
    given, receives the first Trainer's save wall times and stalls."""
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
    saves = _collect_saves(tr.manager)
    check(tr.init_or_restore() == 0, "fresh start")
    tr.run(6)
    run_s = time.monotonic() - t0
    tr.manager.wait()  # the step-6 save, still in flight
    wait_s = time.monotonic() - t0 - run_s
    save_wall = _save_walls(saves)
    if figures is not None:
        figures.update(save_wall_s=[w for w, _ in save_wall],
                       pipeline_wall_s=[p for _, p in save_wall],
                       stall_s=[round(x, 4) for x in tr.stall_times])
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
        f"stall_s {tr.stall_times}; save wall_s (whole, pipeline) {save_wall}; "
        f"init + 6 steps + 3 snapshots {run_s:.2f} s, "
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
                catchup_s=catchup_s, catchup_bytes=delta_bytes), params

def _timed_requests(answer, batches):
    """Answer ``batches[0]`` (warm-up), then each of the rest; returns the
    first answer and the latencies in ms, sorted."""
    first = answer(batches[0])
    lat = []
    for b in batches[1:]:
        t1 = time.monotonic()
        answer(b)
        lat.append((time.monotonic() - t1) * 1e3)
    return first, sorted(lat)


def _batch1_times(kernels, name, kern, plain, symbol, bound_ms, bound_by, shape):
    """Time a kernel at a retrieval request's shape (batch 1) beside its
    plain version, into its entry in the kernel table as ``batch_1``. The
    profiler drops most of these short kernels' events at times (5 of 30
    in each of 8 retakes once): the median is of those a trace of 200
    calls holds, at least 20, and a run whose traces never hold 20 reports
    the kernel's time as not measured (None); the checks are elsewhere."""
    k_ms = kernel_ms(kern, symbol, reps=200, min_events=20)
    call_ms, p_ms = time_ms(kern), time_ms(plain)
    entry = next(k for k in kernels if k["name"] == name)
    entry["batch_1"] = dict(shape=shape, ms=k_ms, call_ms=call_ms, plain_ms=p_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
    kernel = "not measured" if k_ms is None else f"{k_ms:.4f} ms"
    log(f"{name} at batch 1 ({shape}): kernel {kernel} (profiler; one call "
        f"between events {call_ms:.4f} ms), plain {p_ms:.4f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by})")


def phase_retrieval(kernels, params, device="cuda", reduced=False, requests=30):
    """dlrm-rm2's ``retrieval_cand`` cell on phase 4's restored params: one
    user (batch 1) against 1,000,000 candidates a request, ``requests``
    timed after a warm-up. Each request is one ``embedding_bag`` launch
    (the user's 26 fields) and no ``dot_interaction`` launch: the
    reference computes a retrieval's dots with plain products."""
    import numpy as np
    import torch

    from repro_torch.configs import get_cell
    from repro_torch.data.cells import batch_for_cell
    from repro_torch.kernels.dot_interaction import ops as di
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.models import dlrm
    from repro_torch.train.loop import batch_to_device

    cap = None if reduced else VOCAB_CAP
    bundle = get_cell("dlrm-rm2", "retrieval_cand", reduced=reduced, device=device,
                      vocab_cap=cap)
    C = bundle.make_inputs()["candidate_ids"].shape[0]
    check(reduced or C == 1_000_000, f"retrieval_cand scores {C} candidates")
    batches = [batch_for_cell(bundle, 70_000 + i) for i in range(requests + 1)]

    def answer(batch):
        """One request: host arrays in, host probabilities out."""
        return bundle.step_fn(params, batch_to_device(batch, bundle.device)).cpu().numpy()

    if device == "cuda":
        tabs = [params["tables"][f"emb_{f}"] for f in range(bundle.cfg.n_sparse)]
        ids = torch.from_numpy(batches[0]["sparse_ids"]).to(device)
        nbytes = len(tabs) * (tabs[0].shape[1] * 4 + 4 + tabs[0].shape[1] * 2)
        _batch1_times(kernels, "embedding_bag",
                      lambda: eb.embedding_bag_fields(tabs, ids),
                      lambda: eb.embedding_bag_fields_torch(tabs, ids), "embedding_bag_kernel",
                      nbytes / PEAK_BYTES_S * 1e3, "bytes", "(1, 26, 1) over 26 tables")
    eb.LAUNCHES.reset()
    di.LAUNCHES.reset()
    first, lat = _timed_requests(answer, batches)
    launches = {"embedding_bag": eb.LAUNCHES.count, "dot_interaction": di.LAUNCHES.count}
    check(launches == {"embedding_bag": requests + 1, "dot_interaction": 0},
          f"retrieval launches {launches}: one embedding_bag and no "
          f"dot_interaction for each of {requests + 1} requests")
    check(first.shape == (C,) and np.isfinite(first).all()
          and ((first >= 0) & (first <= 1)).all(),
          "retrieval probabilities finite, in [0, 1], one a candidate")
    p50, p99 = lat[len(lat) // 2], lat[int(len(lat) * 0.99)]
    b = batch_to_device(batches[0], bundle.device)
    k = dlrm.serve_retrieval(params, b, bundle.cfg)
    p = dlrm.serve_retrieval(params, b, bundle.cfg, bag=eb.embedding_bag_fields_torch)
    err = float((k - p).abs().max())
    # the dlrm-rm2 bf16 serve bar (tests/test_torch_serving.py)
    check(err <= 1e-3, f"retrieval kernel path vs plain path: max |dp| {err}")
    from torch.profiler import ProfilerActivity, profile

    traced = batches[1:6]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.monotonic()
        for bt in traced:
            answer(bt)
        traced_ms = (time.monotonic() - t1) * 1e3 / len(traced)
    dev_ms, top = _device_split(prof, len(traced), {
        "embedding_bag": ("embedding_bag",), "gemm": ("gemm", "nvjet", "xmma"),
        "memcpy": ("memcpy",)})
    busy_ms = sum(dev_ms.values())
    out = dict(candidates=C, requests=requests, p50_ms=p50, p99_ms=p99,
               candidates_per_s=C / (p50 / 1e3), max_abs_dp=err, launches=launches,
               traced_ms=traced_ms, device_busy_ms=busy_ms,
               device_idle_share=1 - busy_ms / traced_ms)
    log(f"dlrm-rm2 retrieval: {json.dumps(out)}; device ms a request "
        f"{json.dumps({k_: round(v, 4) for k_, v in dev_ms.items()})}; top kernels "
        f"(ms) {json.dumps(top)}")
    record_launches(kernels, "dlrm-rm2 retrieval", {"embedding_bag": launches["embedding_bag"]})
    return out


# ------------------------------------------------------------------ phase 4b

SHARDED_HOSTS = 4


def phase_sharded(kernels, root, single_host=None, device="cuda", reduced=False):
    """dlrm-rm2 at phase 3's width and cap, saving through ``SHARDED_HOSTS``
    simulated hosts into ``root``, through the loss of one host recovered
    ``exact``, another recovered ``cpr``, and a resharded read.
    ``single_host`` holds phase 3's save figures, printed beside these;
    ``device`` and ``reduced`` let the phase be rehearsed on the CPU at the
    reduced cell."""
    import numpy as np
    import torch

    from repro_torch.configs import get_cell
    from repro_torch.core import (CheckNRunManager, CheckpointConfig,
                                  LocalFSStore, PAPER_DEFAULTS, scan_store)
    from repro_torch.core import manifest as mf
    from repro_torch.core import range_reader as rr
    from repro_torch.data.cells import batch_for_cell
    from repro_torch.dist.recovery import shard_nbytes
    from repro_torch.dist.sharding import row_shard_bounds
    from repro_torch.kernels.adaptive_quant import ops as aq
    from repro_torch.kernels.chunk_hash import ops as ch
    from repro_torch.train.loop import Trainer, TrainerConfig, batch_to_device
    from repro_torch.tree import flatten_with_path, keystr, tree_map

    t_phase = time.monotonic()
    H = SHARDED_HOSTS
    cap = None if reduced else VOCAB_CAP
    bundle = get_cell("dlrm-rm2", "train_batch", reduced=reduced, device=device,
                      vocab_cap=cap)
    ckpt = CheckpointConfig(interval_batches=2, policy="intermittent",
                            quant=PAPER_DEFAULTS[4], keep_latest=10,
                            device=device, num_hosts=H)
    store = LocalFSStore(root)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def host_rows(state, key):
        return {n: t.cpu().numpy() for n, t in getattr(state, key)["tables"].items()}

    def shard(name, h, n=H):
        return row_shard_bounds(bundle.tracked[name].rows, n)[h]

    def check_step(s):
        """A committed 4-host step: every chunk under its host's prefix,
        with hash32; one vote a host. Returns its chunk count."""
        man = mf.load(store, s)
        check(man.layout["num_hosts"] == H and man.shards["num_hosts"] == H,
              f"step {s}: the manifest's layout says {H} hosts: {man.layout}")
        check(mf.list_part_hosts(store, s) == list(range(H)), f"step {s}: {H} votes")
        recs = [c for t in man.tables.values() for c in t.chunks]
        check(recs and all(c.hash32 is not None for c in recs), f"hash32 on step {s}")
        check(all(0 <= rr.host_of_chunk_key(c.key) < H and c.key.startswith(
            mf.chunk_host_prefix(s, rr.host_of_chunk_key(c.key))) for c in recs),
              f"step {s}: every chunk key lies under host_<h>/")
        return man.kind, len(recs), man.nbytes_total

    aq.LAUNCHES.reset()
    ch.LAUNCHES.reset()
    tr = Trainer(bundle, store, ckpt, TrainerConfig(total_steps=10, log_every=1))
    saves = _collect_saves(tr.manager)
    check(tr.init_or_restore() == 0, "fresh start")
    t0 = time.monotonic()
    tr.run(6)
    tr.manager.wait()
    run_s = time.monotonic() - t0
    check(mf.list_steps(store) == [2, 4, 6], f"committed steps {mf.list_steps(store)}")
    per_step = {s: check_step(s) for s in (2, 4, 6)}
    if not reduced:
        check(per_step[2][0] == "full" and per_step[2][1] == 188,
              f"the 4-host full save writes 188 chunks: {per_step[2]}")
    n_chunks = sum(v[1] for v in per_step.values())
    check(aq.LAUNCHES.count == n_chunks and ch.LAUNCHES.count == n_chunks,
          f"launches {aq.LAUNCHES.count}, {ch.LAUNCHES.count} == chunks of steps "
          f"2-6 {n_chunks}")
    check(scan_store(LocalFSStore(root)).ok, "integrity scan of the sharded chain")

    # (a) host 1 is lost mid-interval at step 7: exact recovery
    tr.run(1)
    snap6 = tr._boundary_snaps[6]
    victim = 1
    t1 = time.monotonic()
    resumed = tr.recover_host(victim, "exact")
    sync()
    exact_s = time.monotonic() - t1
    check(resumed == 6 and tr.state.step == 6 and tr.last_recovery["kind"] == "partial",
          f"exact recovery resumes at 6, kind partial: {resumed}, {tr.last_recovery}")
    met = tr.manager.metrics()
    part_bytes, part_s = met.restore_bytes_total, met.last_recovery_wall_s
    budget = shard_nbytes(store, victim, 6)
    check(0 < part_bytes <= budget,
          f"restore bytes {part_bytes} <= host {victim}'s shard {budget}")
    probe = CheckNRunManager(LocalFSStore(root), ckpt)
    t1 = time.monotonic()
    full6 = probe.restore(6)
    full_s = time.monotonic() - t1
    full_bytes = probe.metrics().restore_bytes_total
    got, acc = host_rows(tr.state, "params"), host_rows(tr.state, "opt_state")
    for name in bundle.tracked:
        lo, hi = shard(name, victim)
        for mine, snap_rows, full_rows in (
                (got[name], snap6.tables[name], full6.tables[name]),
                (acc[name], snap6.row_state[name]["opt_acc"],
                 full6.row_state[name]["opt_acc"])):
            check(np.array_equal(mine[:lo], snap_rows[:lo])
                  and np.array_equal(mine[hi:], snap_rows[hi:]),
                  f"{name}: survivors' rows == the step-6 boundary snapshot")
            check(np.array_equal(mine[lo:hi], full_rows[lo:hi]),
                  f"{name}: host {victim}'s rows == restore(6)'s")
    del got, acc
    tr.run(2)
    tr.manager.wait()
    check(mf.latest_step(store) == 8, "the save at 8 after the exact recovery")
    per_step[8] = check_step(8)

    # (b) host 2 is lost at step 9: cpr recovery, survivors stay live
    tr.run(1)
    live = host_rows(tr.state, "params")
    victim2 = 2
    t1 = time.monotonic()
    resumed = tr.recover_host(victim2, "cpr")
    sync()
    cpr_s = time.monotonic() - t1
    check(resumed == 9 and tr.state.step == 9 and tr.last_recovery["kind"] == "partial",
          f"cpr recovery resumes at 9, kind partial: {resumed}, {tr.last_recovery}")
    part8 = probe.restore_part(victim2, 8)
    got = host_rows(tr.state, "params")
    for name in bundle.tracked:
        lo, hi = shard(name, victim2)
        check(np.array_equal(got[name][:lo], live[name][:lo])
              and np.array_equal(got[name][hi:], live[name][hi:]),
              f"{name}: rows outside host {victim2}'s shard stay bitwise live")
        check(np.array_equal(got[name][lo:hi], part8.tables[name]),
              f"{name}: host {victim2}'s rows == the committed step 8's")
    del live, got, part8
    tr.run(1)
    tr.manager.wait()
    check(mf.latest_step(store) == 10, "the save at 10 after the cpr recovery")
    per_step[10] = check_step(10)
    results = [f.result() for f, _, _ in saves]
    walls = _save_walls(saves)
    check([r.step for r in results] == [2, 4, 6, 8, 10] and all(
        r.pipeline_stats["num_hosts"] == H for r in results), "five sharded saves")
    launches = {"quant_pack": aq.LAUNCHES.count, "chunk_hash": ch.LAUNCHES.count}
    n_chunks = sum(v[1] for v in per_step.values())
    check(launches["quant_pack"] == n_chunks and launches["chunk_hash"] == n_chunks,
          f"launches {launches} == chunks written {n_chunks}")
    check(scan_store(LocalFSStore(root)).ok, "integrity scan after the recoveries")
    check(all(math.isfinite(h["loss"]) for h in tr.history), "finite losses")

    # (c) host 1's shard of step 6 read under 3 hosts
    t1 = time.monotonic()
    rs3 = probe.restore_part(1, step=6, num_hosts=3)
    reshard_s = time.monotonic() - t1
    check(rs3.extra["shard"]["resharded"] and rs3.extra["shard"]["num_hosts"] == 3
          and probe.metrics().recoveries_resharded_total == 1,
          f"resharded read: {rs3.extra['shard']}")
    for name, rows in rs3.tables.items():
        lo, hi = rs3.extra["shard"]["row_range"][name]
        check((lo, hi) == shard(name, 1, 3) and np.array_equal(rows, full6.tables[name][lo:hi]),
              f"{name}: resharded rows == restore(6)'s")
    probe.close()
    del full6, rs3

    # (d) one training step from one state, three times: the same bits?
    batch = batch_to_device(batch_for_cell(bundle, 4242), bundle.device)
    outs = []
    for _ in range(3):
        st = dataclasses.replace(
            tr.state, params=tree_map(torch.clone, tr.state.params),
            opt_state=tree_map(torch.clone, tr.state.opt_state),
            touched={k: v.clone() for k, v in tr.state.touched.items()})
        new, _ = bundle.step_fn(st, batch)
        outs.append({keystr(p): x for p, x in flatten_with_path(
            {"params": new.params, "opt": new.opt_state})})
    sync()
    differ, worst = {}, 0.0
    for other in outs[1:]:
        for k, a in outs[0].items():
            n = int((a != other[k]).sum())
            if n:
                differ[k] = max(differ.get(k, 0), n)
                worst = max(worst, float((a.float() - other[k].float()).abs().max()))
    del outs, st, new
    tr.close()

    per_host = [{k: (round(v, 4) if isinstance(v, float) else v)
                 for k, v in h.items() if k != "occupancy"}
                for h in results[0].pipeline_stats["per_host"]]
    out = dict(
        phase_s=round(time.monotonic() - t_phase, 1),
        steps_run_s=round(run_s, 3),
        saves={r.step: dict(kind=per_step[r.step][0], chunks=per_step[r.step][1],
                            nbytes=per_step[r.step][2], wall_s=w[0],
                            slowest_host_pipeline_s=w[1])
               for r, w in zip(results, walls)},
        stall_s=[round(x, 4) for x in tr.stall_times],
        single_host=single_host, launches=launches,
        restore_part=dict(wall_s=part_s, payload_bytes=part_bytes, shard_budget=budget),
        full_restore=dict(wall_s=round(full_s, 3), payload_bytes=full_bytes),
        resharded_read_s=round(reshard_s, 3),
        recover_host_s=dict(exact=round(exact_s, 3), cpr=round(cpr_s, 3)),
        repeat_step_bitwise=not differ, repeat_step_differs=differ,
        repeat_step_max_abs=worst)
    log(f"sharded dlrm-rm2, {H} simulated hosts: {json.dumps(out)}")
    log(f"sharded: per-host pipeline stats of the full save at step 2: "
        f"{json.dumps(per_host)}")
    record_launches(kernels, "dlrm-rm2 sharded train", launches)
    return out


# ------------------------------------------------------------------ phase 4c

MP_HOSTS = 4


def start_object_server(root):
    """Start ``python -m repro_torch.core.object_server`` over a
    LocalFSStore at ``root`` on 127.0.0.1; ``_object_server`` waits for it
    to listen."""
    from repro_torch.dist import host_proc

    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.core.object_server", "--root", root,
         "--port", "0"], env=host_proc.child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _object_server(proc):
    """Wait for the server ``start_object_server`` started to listen;
    returns (process, uri)."""
    import select

    ready, _, _ = select.select([proc.stdout], [], [], 120)
    line = proc.stdout.readline() if ready else ""
    if not line.startswith("LISTENING"):
        proc.kill()
        check(False, f"object server did not start: {line!r}")
    _, host, port = line.split()
    return proc, f"http://{host}:{port}"


def _cli(uri, *commands, timeout=600):
    """Each of ``commands`` (argument tuples) as ``python -m
    repro_torch.launch.ckpt`` over ``uri``, all at once: the commands read
    the store and write nothing to it, so they wait out their interpreters'
    start-up together. → [(exit code, text)] in order."""
    from repro_torch.dist import host_proc

    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.ckpt", argv[0],
                               "--dir", uri, *argv[1:]], env=host_proc.child_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for argv in commands]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _chunks_of(store, step):
    return {k: store.get(k) for k in store.list(f"chunks/ckpt_{step:012d}/")}


def phase_multiprocess(kernels, root, device="cuda", reduced=False, server=None):
    """dlrm-rm2 at phase 4b's width and cap, saving through ``MP_HOSTS``
    host processes on the one card (``multiprocess=True``), each its own
    CUDA context, its chunks quantized and hashed by the kernels in that
    process. The store is an object server on 127.0.0.1 over a LocalFSStore
    in ``root``; the hosts reach it only through its ``http://`` URI. A
    full and an incremental save, each byte for byte an in-process 4-host
    save of the same snapshot; a host killed mid-save; the same step's
    drill with a host killed mid-save and respawned alone; the CLI and a
    subscriber over the URI. ``server``: the object server, started
    beforehand over ``root``/server (``start_object_server``), so that its
    interpreter's start-up overlaps earlier work. ``device`` and
    ``reduced`` let the phase be rehearsed on the CPU at the reduced
    cell."""
    import numpy as np

    from repro_torch.configs import get_cell
    from repro_torch.core import (CheckNRunManager, CheckpointConfig, CommitContext,
                                  LocalFSStore, PAPER_DEFAULTS, make_store)
    from repro_torch.core import manifest as mf
    from repro_torch.dist import host_proc
    from repro_torch.dist import recovery
    from repro_torch.kernels.adaptive_quant import ops as aq
    from repro_torch.kernels.chunk_hash import ops as ch
    from repro_torch.serve import CheckpointSubscriber
    from repro_torch.train.loop import Trainer, TrainerConfig

    t_phase = time.monotonic()
    H = MP_HOSTS
    cap = None if reduced else VOCAB_CAP
    bundle = get_cell("dlrm-rm2", "train_batch", reduced=reduced, device=device,
                      vocab_cap=cap)
    server_root, cmp_root = os.path.join(root, "server"), os.path.join(root, "inproc")
    spill_dir = os.path.join(root, "spill")
    os.makedirs(spill_dir)
    srv, uri = _object_server(server or start_object_server(server_root))
    disk = LocalFSStore(server_root)  # the server's files, read to verify
    try:
        store = make_store(uri)
        ckpt = CheckpointConfig(interval_batches=2, policy="one_shot",
                                quant=PAPER_DEFAULTS[4], keep_latest=10, device=device,
                                num_hosts=H, multiprocess=True, spill_dir=spill_dir,
                                heartbeat_s=0.5, commit_timeout_s=120.0,
                                failfast_grace_s=2.0)
        aq.LAUNCHES.reset()
        ch.LAUNCHES.reset()
        tr = Trainer(bundle, store, ckpt, TrainerConfig(total_steps=6, log_every=1))
        saves = _collect_saves(tr.manager)
        kept, save = {}, tr.manager.save

        def keep(snap, block=False):
            kept[snap.step] = snap
            return save(snap, block)

        tr.manager.save = keep
        check(tr.init_or_restore() == 0, "fresh start over the URI")
        tr.run(4)
        tr.manager.wait()
        check(mf.list_steps(store) == [2, 4], f"committed steps {mf.list_steps(store)}")
        # the launcher trained; the host processes encoded
        check(aq.LAUNCHES.count == 0 and ch.LAUNCHES.count == 0,
              f"the launcher launched no encode kernel: {aq.LAUNCHES.count}, "
              f"{ch.LAUNCHES.count}")
        results = [f.result() for f, _, _ in saves]
        walls = _save_walls_mp(saves)
        figures, path_launches = {}, {"quant_pack": 0, "chunk_hash": 0}
        for res, (wall, slowest, waited) in zip(results, walls):
            st = res.pipeline_stats
            man = mf.load(store, res.step)
            n = sum(len(t.chunks) for t in man.tables.values())
            hosts = st["per_host"]
            check(st["exit_codes"] == [0] * H and all(h is not None for h in hosts),
                  f"step {res.step}: every host exited 0 and reported: {st['exit_codes']}")
            got = {k: sum(h["launches"][k] for h in hosts) for k in path_launches}
            check(got == {"quant_pack": n, "chunk_hash": n},
                  f"step {res.step}: the host processes' launches {got} == chunks {n}")
            check(device != "cuda" or all(h["cuda_initialized"] for h in hosts),
                  "each host process made its own CUDA context")
            for k in path_launches:
                path_launches[k] += got[k]
            figures[res.step] = dict(
                kind=man.kind, chunks=n, nbytes=man.nbytes_total, wall_s=wall,
                slowest_host_s=slowest, trainer_waited_s=waited,
                spill_s=round(st["spill_s"], 3),
                spill_bytes=st["spill_bytes"],
                import_s=[round(h["import_s"], 3) for h in hosts],
                startup_s=[round(h["startup_s"], 3) for h in hosts],
                host_pipeline_s=[round(h["pipeline"]["wall_s"], 3) for h in hosts],
                launches=[h["launches"]["quant_pack"] for h in hosts],
                wire_bytes=dict(sent=sum(h["wire"]["bytes_sent"] for h in hosts),
                                received=sum(h["wire"]["bytes_received"] for h in hosts)))
        check(figures[2]["kind"] == "full" and figures[4]["kind"] == "incremental",
              f"a full and an incremental save: {figures}")

        # (a) the same snapshots through an in-process 4-host save: the same
        # chunk objects, key by key (the store format is the contract)
        cmp_store = LocalFSStore(cmp_root)
        cmp_cfg = dataclasses.replace(ckpt, multiprocess=False, async_write=False,
                                      spill_dir=None, heartbeat_s=None)
        cmp = CheckNRunManager(cmp_store, cmp_cfg)
        for s_ in (2, 4):
            cmp.save(kept[s_]).result()
            a, b = _chunks_of(disk, s_), _chunks_of(cmp_store, s_)
            check(a and a == b, f"step {s_}: {len(a)} chunk objects over HTTP from "
                  f"{H} processes == the in-process save's {len(b)}, byte for byte")
        cmp.close()

        # (b) host 1 killed mid-save: the save raises, step 4 stays latest
        # and restores; a subscriber over the URI matches restore() bitwise
        tr.manager.config.proc_fault = "1:mid_chunks:3"
        tr.run(2)
        try:
            tr.manager.wait()
            check(False, "the save with a killed host raised")
        except host_proc.MultiprocessSaveError as e:
            failed = str(e).splitlines()[0]
        tr.manager.config.proc_fault = None
        check(mf.latest_step(store) == 4, f"step 4 stays latest: {mf.latest_step(store)}")
        probe = CheckNRunManager(make_store(uri), CheckpointConfig(device=device))
        t1 = time.monotonic()
        r4 = probe.restore()
        restore_s = time.monotonic() - t1
        check(r4.step == 4 and r4.chain_len == 2, f"restored {r4.step}, chain {r4.chain_len}")
        sub = CheckpointSubscriber(make_store(uri))
        t1 = time.monotonic()
        check(sub.poll_once() and sub.applied_step == 4, f"remote subscriber: {sub.health}")
        sync_s = time.monotonic() - t1
        with sub.server.pinned() as v:
            for name, want in r4.tables.items():
                check(v.tables()[name].tobytes() == want.tobytes(),
                      f"{name}: the remote subscriber's table == restore() bit for bit")
        del r4, sub

        # (c) the drill: step 6 as a full save from its snapshot, host 1
        # SIGKILLed mid-chunks; only host 1 is respawned, against the same
        # spill, and completes the quorum the survivors' votes left
        snap6, victim = kept[6], 1
        for k in store.list(mf.part_prefix(6)):
            store.delete(k)
        qcfg = PAPER_DEFAULTS[4].resolve()
        ctx = CommitContext(kind="full", base_step=6, prev_step=4,
                            quant=dataclasses.asdict(qcfg), policy={"name": "full_only"},
                            extra={"bitwidth": None})
        spill = tempfile.mkdtemp(prefix="drill-", dir=spill_dir)
        host_proc.write_spill(spill, snap6, {}, {}, dataclasses.replace(
            ckpt, policy="full_only"), 6, H, ctx, True)
        procs = []
        t1 = time.monotonic()
        for h in range(H):
            with open(os.path.join(spill, f"log_{h}"), "wb") as log_f:
                procs.append(subprocess.Popen(host_proc.host_command(
                    uri, spill, h, fault="mid_chunks:3" if h == victim else None,
                    heartbeat_s=0.5, commit_timeout_s=5.0, watch_parent=True),
                    env=host_proc.child_env(), stdout=log_f, stderr=subprocess.STDOUT))
        codes = [p.wait(timeout=600) for p in procs]
        check(codes[victim] == -9 and all(c == 3 for h, c in enumerate(codes) if h != victim),
              f"drill exit codes {codes}: the victim killed, the rest timed out")
        check(not store.exists(mf.manifest_key(6))
              and recovery.read_heartbeat(store, victim) is not None,
              "step 6 not committed; the victim beat before it died")
        sup = recovery.RecoverySupervisor(store, H)
        check(victim in [f.host for f in sup.detect_failures(dict(enumerate(procs)))],
              "the supervisor condemns the victim")
        stats = [host_proc.load_host_stats(spill, h) for h in range(H)]
        t2 = time.monotonic()
        p = sup.respawn(uri, spill, victim, heartbeat_s=0.5, commit_timeout_s=120.0,
                        log_path=os.path.join(spill, "respawn.log"))
        check(p.wait(timeout=600) == 0 and mf.latest_step(store) == 6,
              f"the respawned host 1 committed step 6: {mf.latest_step(store)}")
        respawn_s = time.monotonic() - t2
        drill_s = time.monotonic() - t1
        stats[victim] = host_proc.load_host_stats(spill, victim)
        man6 = mf.load(store, 6)
        n6 = sum(len(t.chunks) for t in man6.tables.values())
        got = {k: sum(st["launches"][k] for st in stats) for k in path_launches}
        check(got == {"quant_pack": n6, "chunk_hash": n6},
              f"the drill's reported launches {got} == step 6's chunks {n6} (the "
              f"survivors' and the respawned host's)")
        for k in path_launches:
            path_launches[k] += got[k]
        cmp = CheckNRunManager(cmp_store, dataclasses.replace(cmp_cfg, policy="full_only"))
        cmp.save(snap6).result()
        cmp.close()
        a, b = _chunks_of(disk, 6), _chunks_of(cmp_store, 6)
        check(a and a == b, f"step 6 after the respawn: {len(a)} chunk objects == the "
              f"in-process save's, byte for byte")
        shutil.rmtree(spill, ignore_errors=True)
        del kept, snap6

        # (d) the CLI over the URI
        t1 = time.monotonic()
        (rc, out), (rc_r, out_r), (rc_s, out_s) = _cli(
            uri, ("scan",), ("recover", "--host", "1", "--device", device), ("subscribe",))
        cli_s = time.monotonic() - t1
        check(rc == 0 and "all 3 step(s) clean" in out, f"ckpt scan: {rc} {out[-400:]}")
        rc, out = rc_r, out_r
        m = re.search(r"recovered host 1 \(partial\) at step 6 .* ([\d,]+) bytes fetched", out)
        check(rc == 0 and m is not None, f"ckpt recover: {rc} {out[-400:]}")
        fetched = int(m.group(1).replace(",", ""))
        planned = recovery.shard_nbytes(store, 1, 6)
        man_bytes = disk.size(mf.manifest_key(6))  # the chain is step 6 alone
        check(fetched == planned + man_bytes,
              f"ckpt recover fetched {fetched} B == host 1's shard {planned} B + "
              f"step 6's manifest {man_bytes} B")
        rc, out = rc_s, out_s
        check(rc == 0 and "serving step 6" in out, f"ckpt subscribe: {rc} {out[-400:]}")
        tr.close()
        probe.close()
    finally:
        srv.terminate()
        srv.wait(timeout=30)
    out = dict(phase_s=round(time.monotonic() - t_phase, 1), hosts=H, saves=figures,
               stall_s=[round(x, 4) for x in tr.stall_times],
               launches=path_launches, killed_save=failed,
               restore_s=round(restore_s, 3), remote_subscriber_sync_s=round(sync_s, 3),
               drill=dict(wall_s=round(drill_s, 3), respawn_s=round(respawn_s, 3),
                          chunks=n6, exit_codes=codes),
               cli_recover=dict(fetched_bytes=fetched, shard_bytes=planned,
                                manifest_bytes=man_bytes), cli_s=round(cli_s, 3))
    log(f"multiprocess dlrm-rm2, {H} host processes over {uri}: {json.dumps(out)}")
    record_launches(kernels, "dlrm-rm2 host processes", path_launches)
    return out


# ------------------------------------------------------------------ the model phases' shared steps


def _served_params(bundle, root, device):
    """The newest chain in ``root`` restored into ``bundle``'s params;
    returns (params, restored step, seconds)."""
    from repro_torch.core import CheckNRunManager, CheckpointConfig, LocalFSStore
    from repro_torch.train.state import restore_train_state

    t0 = time.monotonic()
    mgr = CheckNRunManager(LocalFSStore(root), CheckpointConfig(device=device))
    restored = mgr.restore()
    mgr.close()
    params = restore_train_state(bundle.make_state(), restored, bundle.tracked).params
    return params, restored.step, time.monotonic() - t0


TRACE_GROUPS = {"gemm": ("gemm", "nvjet", "xmma", "cutlass"),
                "embedding_bag": ("embedding_bag",), "memcpy": ("memcpy",),
                "index": ("index", "scatter", "gather", "embedding")}


def _traced_split(fn, groups=None):
    """One call of ``fn`` under the profiler, its result dropped: (wall s,
    device busy s, device ms by kernel group, the top kernels in ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t1
    split, top = _device_split(prof, 1, groups or TRACE_GROUPS)
    return dict(wall_s=round(wall, 4), busy_s=round(sum(split.values()) / 1e3, 4),
                ms={k: round(v, 2) for k, v in split.items()}, top_ms=top)


def _train_phase(arch, bundle, root, device, steps, fail_at=None, groups=None,
                 trace=True, ckpt_kw=None):
    """Train ``bundle`` from a fresh start for ``steps`` steps with 4-bit
    adaptive saves every 2 steps into ``root`` (the intermittent policy), and
    inject a failure at ``fail_at`` if given; with ``trace``, one more step
    (on a batch made beforehand) under the profiler, split by ``groups``.
    ``ckpt_kw`` adds to the checkpoint config. Returns (trainer, closed;
    its live tables as host arrays, and of a tracked block under ``dense``
    its 2-D view and optimizer state; figures, with such blocks' touched
    masks after each step: the units touched since the last snapshot)."""
    import torch

    from repro_torch.core import CheckpointConfig, LocalFSStore, PAPER_DEFAULTS
    from repro_torch.kernels.adaptive_quant import ops as aq
    from repro_torch.kernels.chunk_hash import ops as ch
    from repro_torch.data.cells import batch_for_cell
    from repro_torch.train.loop import (SimulatedFailure, Trainer, TrainerConfig,
                                        batch_to_device)

    step_s, touched_by_step = [], []
    step_fn = bundle.step_fn
    blocks = {n: sp for n, sp in bundle.tracked.items() if sp.path[0] == "dense"}

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t1 = time.monotonic()
        new_state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t1)
        # the running OR since the last snapshot, which resets it
        touched_by_step.append({n: new_state.touched[n].cpu() for n in blocks})
        return new_state, metrics

    bundle.step_fn = timed_step
    ckpt = CheckpointConfig(interval_batches=2, policy="intermittent",
                            quant=PAPER_DEFAULTS[4], keep_latest=10, device=device,
                            **(ckpt_kw or {}))
    for c in (aq.LAUNCHES, ch.LAUNCHES):
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    tr = Trainer(bundle, LocalFSStore(root), ckpt, TrainerConfig(total_steps=steps,
                                                                  log_every=1))
    saves = _collect_saves(tr.manager)
    check(tr.init_or_restore() == 0, f"{arch} fresh start")
    tr.run(steps)
    run_s = time.monotonic() - t0
    tr.manager.wait()
    wait_s = time.monotonic() - t0 - run_s
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    split = None
    if trace:
        batch = batch_to_device(batch_for_cell(bundle, steps), bundle.device)
        split = _traced_split(lambda: step_fn(tr.state, batch), groups)
        del batch
    live = {k: v.cpu().numpy() for k, v in tr.state.params["tables"].items()}
    live.update(_tracked_blocks(tr.state, blocks))
    if fail_at is not None:
        try:
            tr.run(2, fail_at_step=fail_at)
            raise RuntimeError("the injected failure did not fire")
        except SimulatedFailure as e:
            log(f"injected: {e}")
    tr.close()
    bundle.step_fn = step_fn
    check(all(math.isfinite(h["loss"]) for h in tr.history), f"{arch} finite losses")
    return tr, live, dict(
        ckpt=ckpt, step_s=[round(t, 4) for t in step_s], peak_train_gb=peak_gb,
        traced_step=split,
        run_s=run_s, last_save_wait_s=wait_s, save_walls=_save_walls(saves),
        stall_s=[round(t, 4) for t in tr.stall_times],
        losses=[round(h["loss"], 5) for h in tr.history], touched_by_step=touched_by_step,
        launches={"quant_pack": aq.LAUNCHES.count, "chunk_hash": ch.LAUNCHES.count})


def _tracked_blocks(state, blocks):
    """Host copies of tracked blocks under ``dense`` (the MoE experts): each
    one's 2-D checkpoint view, and its optimizer state's as
    ``<name>.opt_acc2d``."""
    from repro_torch.train.state import tree_get

    out = {}
    for name, sp in blocks.items():
        out[name] = tree_get(state.params, sp.path).reshape(sp.rows, sp.dim).cpu().numpy()
        acc = tree_get(state.opt_state, sp.path)
        out[f"{name}.opt_acc2d"] = acc.reshape(sp.rows, -1).cpu().numpy()
    return out


def _saved_steps(store, steps):
    """Per committed step: its kind, chunk count and bytes; every chunk
    carries its hash."""
    from repro_torch.core import manifest as mf

    out = {}
    for s in steps:
        man = mf.load(store, s)
        recs = [c for t in man.tables.values() for c in t.chunks]
        check(all(c.hash32 is not None for c in recs), f"hash32 on step {s}")
        out[s] = dict(kind=man.kind, chunks=len(recs), nbytes=man.nbytes_total,
                      rows=sum(c.n_rows for c in recs))
    return out


def _resume_and_save(bundle, root, ckpt, at, against_manager=True):
    """A fresh Trainer resumes from the chain in ``root`` at step ``at``,
    equal to ``manager.restore()`` (without ``against_manager``, that
    restore is skipped and the Trainer's restored tables stand in for its
    result), and trains 2 steps through one more save, which is waited
    for. Returns (restore result, restore seconds, resumed Trainer's
    history, the new save's chunk count, launches of the save kernels
    meanwhile)."""
    import types

    import torch

    from repro_torch.core import CheckNRunManager, LocalFSStore, scan_store
    from repro_torch.core import manifest as mf
    from repro_torch.kernels.adaptive_quant import ops as aq
    from repro_torch.kernels.chunk_hash import ops as ch
    from repro_torch.train.loop import Trainer, TrainerConfig

    t0 = time.monotonic()
    if against_manager:
        rs = CheckNRunManager(LocalFSStore(root), ckpt).restore()
        check(rs.step == at, f"restored step {rs.step}")
    before = (aq.LAUNCHES.count, ch.LAUNCHES.count)
    tr2 = Trainer(bundle, LocalFSStore(root), ckpt, TrainerConfig(total_steps=2, log_every=1))
    check(tr2.init_or_restore() == at, f"resume at step {at}")
    restore_s = time.monotonic() - t0
    if against_manager:
        for name in list(rs.tables)[:3]:
            check(torch.equal(tr2.state.params["tables"][name].cpu(),
                              torch.from_numpy(rs.tables[name])),
                  f"{name}: Trainer restore == manager.restore()")
    else:
        blocks = {n: sp for n, sp in bundle.tracked.items() if sp.path[0] == "dense"}
        rs = types.SimpleNamespace(step=at, tables={
            k: v.cpu().numpy() for k, v in tr2.state.params["tables"].items()})
        rs.tables.update(_tracked_blocks(tr2.state, blocks))
    tr2.run(2)
    tr2.manager.wait()
    tr2.close()
    check(all(math.isfinite(h["loss"]) for h in tr2.history), "finite losses after restore")
    man = mf.load(LocalFSStore(root), at + 2)
    n = sum(len(t.chunks) for t in man.tables.values())
    resumed = {"quant_pack": aq.LAUNCHES.count - before[0],
               "chunk_hash": ch.LAUNCHES.count - before[1]}
    check(resumed == {"quant_pack": n, "chunk_hash": n},
          f"resumed launches {resumed} == step-{at + 2} chunks {n}")
    check(scan_store(LocalFSStore(root)).ok, "integrity scan after the resumed save")
    return rs, restore_s, tr2, n, resumed


# ------------------------------------------------------------------ phase 5


def phase_bert4rec(kernels, root, device="cuda", reduced=False, p99_batches=200,
                   bulk_batches=4, retrieval_requests=30):
    """bert4rec at full width: train through saves and a restore into
    ``root``, serve from that chain through ``flash_attention``, run the
    ``adaptive_quant`` op on the trained item table, then retrieval (one
    sequence against 1,000,000 candidates a request). ``device`` and
    ``reduced`` let the phase be rehearsed on the CPU at the reduced cell."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_cell
    from repro_torch.core import CheckNRunManager, CheckpointConfig, LocalFSStore
    from repro_torch.core import manifest as mf
    from repro_torch.core.quantize import dequantize, mean_l2_loss, uniform_quantize
    from repro_torch.data.cells import batch_for_cell
    from repro_torch.kernels.adaptive_quant import ops as aq
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import bert4rec
    from repro_torch.train.loop import batch_to_device
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
    tr, live, fig = _train_phase("bert4rec", bundle, root, device, 4)
    store = LocalFSStore(root)
    steps = mf.list_steps(store)
    check(steps == [2, 4], f"bert4rec committed steps {steps}")
    saves = _saved_steps(store, steps)
    check(saves[2]["kind"] == "full" and saves[2]["rows"] == n_items,
          f"the first save is full: {saves[2]}")
    check(saves[4]["kind"] != "full" and 0 < saves[4]["rows"] < n_items,
          f"the second save is incremental: {saves[4]}")
    n_chunks = sum(v["chunks"] for v in saves.values())
    check(fig["launches"] == {"quant_pack": n_chunks, "chunk_hash": n_chunks},
          f"bert4rec save launches {fig['launches']} == chunks written {n_chunks}")
    log(f"bert4rec traced step: {json.dumps(fig['traced_step'])}")
    log(f"bert4rec train: step times {fig['step_s']} s; stalls {fig['stall_s']} s; init "
        f"+ 4 steps + 2 snapshots {fig['run_s']:.2f} s, then the last save "
        f"{fig['last_save_wait_s']:.2f} s; peak device memory {fig['peak_train_gb']:.2f} "
        f"GB; saves {json.dumps(saves)} (incremental row share "
        f"{saves[4]['rows'] / n_items:.4f}); losses {fig['losses']}; accuracy "
        f"{[round(h['accuracy'], 5) for h in tr.history]}")

    # (b) restore, resume, one more save (step 6) from the restored state
    rs, restore_s, tr2, n6, resumed = _resume_and_save(bundle, root, fig["ckpt"], 4)
    check(rs.chain_len == 2, f"restored chain {rs.chain_len}")
    rel = float(np.abs(rs.tables["item_0"] - live["item_0"]).mean()
                / np.abs(live["item_0"]).mean())
    check(0 < rel < 0.1, f"4-bit restore error {rel} within the quantization bound")
    trained = tr2.state.params["tables"]["item_0"]
    launches = {k: fig["launches"][k] + resumed[k] for k in resumed}
    record_launches(kernels, "bert4rec train", launches)
    log(f"bert4rec restore of step 4 (chain 2) {restore_s:.2f} s, mean rel err "
        f"{rel:.5f}; resumed losses {[round(h['loss'], 5) for h in tr2.history]}; "
        f"step-6 save {n6} chunks; launches {launches}")

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

    # (f) retrieval: one user's sequence against 1,000,000 candidates a
    # request, on the served params
    rbundle = get_cell("bert4rec", "retrieval_cand", reduced=reduced, device=device)
    C = rbundle.make_inputs()["candidate_ids"].shape[0]
    check(reduced or C == 1_000_000, f"retrieval_cand scores {C} candidates")
    rbatches = [batch_for_cell(rbundle, 70_000 + i) for i in range(retrieval_requests + 1)]
    if device == "cuda":
        qkv = [torch.randn((1, 200, 2, 32), device=device).to(torch.bfloat16)
               for _ in range(3)]
        _batch1_times(kernels, "flash_attention",
                      lambda: fa.flash_attention_cuda(*qkv, causal=False),
                      lambda: fa.flash_attention_torch(*qkv, causal=False),
                      "flash_kernel_mma", *flash_bound(1, 200, 200, 2, 32, 2),
                      "(1, 200, 2, 32) bf16, not causal")
    fa.MMA_LAUNCHES.reset()
    fa.SIMT_LAUNCHES.reset()
    first, rlat = _timed_requests(lambda b: answer(rbundle, params, b), rbatches)
    r_launches = {"flash_attention": fa.MMA_LAUNCHES.count}
    check(r_launches["flash_attention"] == 2 * (retrieval_requests + 1)
          and fa.SIMT_LAUNCHES.count == 0,
          f"retrieval flash launches {r_launches} on the tensor-core route == 2 "
          f"blocks x {retrieval_requests + 1} requests, {fa.SIMT_LAUNCHES.count} f32")
    check(first.shape == (C,) and np.isfinite(first).all(),
          "retrieval scores finite, one a candidate")
    r50, r99 = rlat[len(rlat) // 2], rlat[int(len(rlat) * 0.99)]
    b = batch_to_device(rbatches[0], rbundle.device)
    k_scores = bert4rec.serve_retrieval(params, b, rbundle.cfg)
    p_scores = bert4rec.serve_retrieval(params, b, rbundle.cfg,
                                        attention=fa.flash_attention_torch)
    r_err = float((k_scores - p_scores).abs().max())
    check(r_err <= 2e-2, f"retrieval kernel vs plain attention: max |ds| {r_err}")
    # the same sequence and its first 100 candidates through serve: the
    # encode is the same, only the last product's order differs
    sub = dict(items=b["items"], candidate_ids=b["candidate_ids"][None, :100])
    s_err = float((bert4rec.serve(params, sub, rbundle.cfg)[0] - k_scores[:100])
                  .abs().max())
    check(s_err <= 1e-4, f"retrieval vs serve on 100 candidates: max |ds| {s_err}")
    retrieval = dict(candidates=C, requests=retrieval_requests, p50_ms=r50, p99_ms=r99,
                     candidates_per_s=C / (r50 / 1e3), max_abs_ds=r_err,
                     vs_serve_max_abs_ds=s_err, launches=r_launches)
    log(f"bert4rec retrieval: {json.dumps(retrieval)}")
    record_launches(kernels, "bert4rec retrieval", r_launches)
    return dict(step_s=fig["step_s"], peak_train_gb=fig["peak_train_gb"],
                first_answer_s=first_s,
                p50_ms=p50, p99_ms=p99_ms, bulk_rows_s=rows_s, peak_bulk_gb=peak_bulk_gb,
                serve_max_abs_ds=serve_err, l2=l2, retrieval=retrieval)


# ------------------------------------------------------------------ phase 6


XDEEPFM_ROWS = 22_451_200  # rows of each xDeepFM table family


def phase_xdeepfm(kernels, root, device="cuda", reduced=False, p99_batches=100,
                  bulk_batches=3, retrieval_requests=5):
    """xDeepFM at full width, no cut: train through 4-bit adaptive saves, a
    failure, a restore and one more save into ``root``; serve from that
    chain (``serve_p99``, ``serve_bulk``) and retrieve (one user against
    1,000,000 candidates). Each forward is two ``embedding_bag`` launches,
    one for the 39 dim-10 ``emb_*`` fields and one for the 39 dim-1
    ``lin_*`` fields; each save chunk one ``quant_pack`` and one
    ``chunk_hash``."""
    import numpy as np
    import torch

    from repro_torch.configs import get_cell
    from repro_torch.core import LocalFSStore
    from repro_torch.core import manifest as mf
    from repro_torch.data.cells import batch_for_cell
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.models import xdeepfm
    from repro_torch.train.loop import batch_to_device

    bundle = get_cell("xdeepfm", "train_batch", reduced=reduced, device=device)
    cfg = bundle.cfg
    F = cfg.n_sparse
    check(reduced or cfg.n_sparse == 39 and cfg.embed_dim == 10
          and cfg.cin_layers == (200, 200, 200) and cfg.mlp == (400, 400)
          and sum(cfg.vocab_sizes) == XDEEPFM_ROWS and cfg.compute_dtype == torch.bfloat16
          and bundle.make_inputs()["sparse_ids"].shape == (65536, 39, 1),
          "xdeepfm at full width")
    rows = sum(cfg.vocab_sizes)
    log(f"xdeepfm full width: {F} fields, {rows} rows at dim {cfg.embed_dim} and "
        f"{rows} at dim 1 ({rows * (cfg.embed_dim + 1) * 4 / 1e9:.2f} GB f32), CIN "
        f"{cfg.cin_layers}, MLP {cfg.mlp}, batch "
        f"{bundle.make_inputs()['sparse_ids'].shape[0]}")

    # (a) train: saves at 2 (full), 4, 6; a failure at 7
    tr, live, fig = _train_phase("xdeepfm", bundle, root, device, 6, fail_at=7)
    store = LocalFSStore(root)
    steps = mf.list_steps(store)
    check(steps == [2, 4, 6], f"xdeepfm committed steps {steps}")
    saves = _saved_steps(store, steps)
    man2 = mf.load(store, 2)
    by_family = {p: sum(len(t.chunks) for n, t in man2.tables.items() if n.startswith(p))
                 for p in ("emb_", "lin_")}
    n_chunks = sum(v["chunks"] for v in saves.values())
    check(saves[2]["kind"] == "full" and saves[2]["rows"] == 2 * rows,
          f"the first save is full: {saves[2]}")
    check(reduced or by_family == {"emb_": 376, "lin_": 376},
          f"a full save writes 376 chunks a family: {by_family}")
    check(fig["launches"] == {"quant_pack": n_chunks, "chunk_hash": n_chunks},
          f"xdeepfm save launches {fig['launches']} == chunks written {n_chunks}")
    log(f"xdeepfm traced step: {json.dumps(fig['traced_step'])}")
    log(f"xdeepfm train: step times {fig['step_s']} s; peak device memory "
        f"{fig['peak_train_gb']:.2f} GB; stalls {fig['stall_s']} s; init + 6 steps + 3 "
        f"snapshots {fig['run_s']:.2f} s, then the last save {fig['last_save_wait_s']:.2f} "
        f"s; save wall_s (whole, pipeline) {fig['save_walls']}; saves {json.dumps(saves)} "
        f"(full: {json.dumps(by_family)}); losses {fig['losses']}")

    # (b) restore step 6: emb_* within the 4-bit bar, each lin_* value its
    # fp16 rounding (a one-value row: scale 1, code 0, the zero in fp16);
    # then resume and save at 8
    rs, restore_s, tr2, n8, resumed = _resume_and_save(bundle, root, fig["ckpt"], 6)
    rel = {}
    for i in range(F):
        a, want = rs.tables[f"emb_{i}"], live[f"emb_{i}"]
        rel[i] = float(np.abs(a - want).mean() / np.abs(want).mean())
        check(np.array_equal(rs.tables[f"lin_{i}"],
                             live[f"lin_{i}"].astype(np.float16).astype(np.float32)),
              f"lin_{i} restores as its fp16 values")
    check(all(0 < r < 0.1 for r in rel.values()), f"emb_* restore error {rel}")
    launches = {k: fig["launches"][k] + resumed[k] for k in resumed}
    record_launches(kernels, "xdeepfm train", launches)
    log(f"xdeepfm restore of step 6 (chain {rs.chain_len}) {restore_s:.2f} s; emb_* mean "
        f"rel err worst {max(rel.values()):.5f}, best {min(rel.values()):.5f}; every "
        f"lin_* value its fp16 rounding; resumed losses "
        f"{[round(h['loss'], 5) for h in tr2.history]}; step-8 save {n8} chunks; "
        f"launches {launches}")
    del tr, tr2, live, rs
    torch.cuda.empty_cache()

    # (c) serve from the chain: two embedding_bag launches a forward
    p99 = get_cell("xdeepfm", "serve_p99", reduced=reduced, device=device)
    bulk = get_cell("xdeepfm", "serve_bulk", reduced=reduced, device=device)
    batches = [batch_for_cell(p99, 50_000 + i) for i in range(p99_batches)]
    bulk_np = [batch_for_cell(bulk, 60_000 + i) for i in range(bulk_batches)]
    eb.LAUNCHES.reset()
    t0 = time.monotonic()
    params, step, _ = _served_params(p99, root, device)
    answer = lambda bnd, b: bnd.step_fn(params, batch_to_device(b, bnd.device)).cpu().numpy()
    first = answer(p99, batches[0])
    first_s = time.monotonic() - t0
    check(step == 8 and np.isfinite(first).all(), f"served from step {step}")
    _, lat = _timed_requests(lambda b: answer(p99, b), batches)
    p50, p99_ms = lat[len(lat) // 2], lat[int(len(lat) * 0.99)]
    torch.cuda.reset_peak_memory_stats()
    first_bulk, bulk_lat = _timed_requests(lambda b: answer(bulk, b), bulk_np)
    peak_bulk_gb = torch.cuda.max_memory_allocated() / 1e9
    n_bulk = bulk_np[0]["sparse_ids"].shape[0]
    rows_s = n_bulk * len(bulk_lat) / (sum(bulk_lat) / 1e3)
    check(first_bulk.shape == (n_bulk,) and np.isfinite(first_bulk).all()
          and ((first_bulk >= 0) & (first_bulk <= 1)).all(),
          "serve_bulk probabilities finite, in [0, 1], one a row")
    bulk_split = _traced_split(lambda: answer(bulk, bulk_np[1]))
    log(f"xdeepfm traced serve_bulk batch: {json.dumps(bulk_split)}")
    n_fwd = p99_batches + 1 + bulk_batches + 1
    check(eb.LAUNCHES.count == 2 * n_fwd,
          f"embedding_bag launches {eb.LAUNCHES.count} == 2 x {n_fwd} forwards")
    serve_launches = eb.LAUNCHES.count
    b = batch_to_device(batches[0], p99.device)
    k = xdeepfm.serve(params, b, p99.cfg)
    p = xdeepfm.serve(params, b, p99.cfg, bag=eb.embedding_bag_fields_torch)
    check(torch.equal(k, p), f"kernel vs plain probabilities bit-equal (H = 1): max "
          f"|dp| {float((k - p).abs().max())}")
    log(f"xdeepfm serve: restore of step {step} to the first answer {first_s:.2f} s; "
        f"serve_p99 {p99_batches} batches of {batches[0]['sparse_ids'].shape[0]}: p50 "
        f"{p50:.3f} ms, p99 {p99_ms:.3f} ms a batch (host arrays in, host probabilities "
        f"out); serve_bulk {len(bulk_lat)} batches of {n_bulk} after one: "
        f"{[round(t, 3) for t in bulk_lat]} ms, {rows_s:.0f} rows/s, peak device memory "
        f"{peak_bulk_gb:.2f} GB; embedding_bag launches {serve_launches} (2 a forward); "
        f"kernel vs plain probabilities bit-equal")

    # (d) retrieval: the user's 39 fields and the candidates' field-0 bags,
    # four launches a request, then the CIN and the MLP in chunks of 8,192
    rbundle = get_cell("xdeepfm", "retrieval_cand", reduced=reduced, device=device)
    C = rbundle.make_inputs()["candidate_ids"].shape[0]
    n_scores = xdeepfm.n_retrieval_scores(C)
    check(reduced or (C, n_scores) == (1_000_000, 999_424),
          f"retrieval_cand scores {n_scores} of {C} candidates")
    rbatches = [batch_for_cell(rbundle, 70_000 + i) for i in range(retrieval_requests + 1)]
    eb.LAUNCHES.reset()
    first, rlat = _timed_requests(lambda b: answer(rbundle, b), rbatches)
    r_split = _traced_split(lambda: answer(rbundle, rbatches[1]))
    log(f"xdeepfm traced retrieval request: {json.dumps(r_split)}")
    r_launches = eb.LAUNCHES.count
    check(r_launches == 4 * (retrieval_requests + 2),
          f"retrieval embedding_bag launches {r_launches} == 4 x {retrieval_requests + 2}")
    check(first.shape == (n_scores,) and np.isfinite(first).all()
          and ((first >= 0) & (first <= 1)).all(),
          f"retrieval probabilities finite, in [0, 1], {n_scores} of them")
    b = batch_to_device(rbatches[0], rbundle.device)
    k = xdeepfm.serve_retrieval(params, b, rbundle.cfg)
    p = xdeepfm.serve_retrieval(params, b, rbundle.cfg, bag=eb.embedding_bag_fields_torch)
    check(torch.equal(k, p), "retrieval kernel vs plain lookups bit-equal")
    r50, r99 = rlat[len(rlat) // 2], rlat[int(len(rlat) * 0.99)]
    retrieval = dict(candidates=C, scores=n_scores, requests=retrieval_requests,
                     p50_ms=r50, p99_ms=r99, candidates_per_s=n_scores / (r50 / 1e3),
                     launches_a_request=r_launches // (retrieval_requests + 2))
    log(f"xdeepfm retrieval: {json.dumps(retrieval)}")
    record_launches(kernels, "xdeepfm serve", {"embedding_bag": serve_launches})
    record_launches(kernels, "xdeepfm retrieval", {"embedding_bag": r_launches})
    del params
    torch.cuda.empty_cache()
    return dict(step_s=fig["step_s"], peak_train_gb=fig["peak_train_gb"], saves=saves,
                restore_s=restore_s, first_answer_s=first_s, p50_ms=p50, p99_ms=p99_ms,
                bulk_rows_s=rows_s, retrieval=retrieval, traced_step=fig["traced_step"],
                traced_bulk=bulk_split, traced_retrieval=r_split)


# ------------------------------------------------------------------ phase 7


MIND_ITEMS = 1_000_448  # MIND's catalog, padded to 512


def phase_mind(kernels, root, device="cuda", reduced=False, p99_batches=100,
               bulk_batches=3, retrieval_requests=10):
    """MIND at full width, no cut: train through 4-bit adaptive saves at 2
    (full) and 4, a restore and a save at 6; serve from that chain and
    retrieve (one user's interests against 1,000,000 candidates). Its
    lookups are plain gathers, as the reference's ``jnp.take``: no kernel
    runs in a forward; its saves run ``quant_pack`` and ``chunk_hash``.
    Returns the trained item table (on the card) for the k-means phase."""
    import numpy as np
    import torch

    from repro_torch.configs import get_cell
    from repro_torch.core import LocalFSStore
    from repro_torch.core import manifest as mf
    from repro_torch.data.cells import batch_for_cell
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.train.loop import batch_to_device

    bundle = get_cell("mind", "train_batch", reduced=reduced, device=device)
    cfg = bundle.cfg
    specs = bundle.make_inputs()
    check(reduced or cfg.n_items == MIND_ITEMS and cfg.embed_dim == 64
          and cfg.n_interests == 4 and cfg.capsule_iters == 3 and cfg.hist_len == 50
          and cfg.compute_dtype == torch.bfloat16
          and specs["hist"].shape == (65536, 50) and specs["neg_ids"].shape == (1024,),
          "mind at full width")
    log(f"mind full width: {cfg.n_items} items x {cfg.embed_dim}, {cfg.n_interests} "
        f"interests, {cfg.capsule_iters} routing iterations, history {cfg.hist_len}, "
        f"batch {specs['hist'].shape[0]}, {specs['neg_ids'].shape[0]} shared negatives")
    tr, live, fig = _train_phase("mind", bundle, root, device, 4)
    store = LocalFSStore(root)
    steps = mf.list_steps(store)
    check(steps == [2, 4], f"mind committed steps {steps}")
    saves = _saved_steps(store, steps)
    n_chunks = sum(v["chunks"] for v in saves.values())
    check(saves[2]["kind"] == "full" and saves[2]["rows"] == cfg.n_items
          and (reduced or saves[2]["chunks"] == 16), f"the first save is full: {saves[2]}")
    check(saves[4]["kind"] != "full" and 0 < saves[4]["rows"] < cfg.n_items,
          f"the second save is incremental: {saves[4]}")
    check(fig["launches"] == {"quant_pack": n_chunks, "chunk_hash": n_chunks},
          f"mind save launches {fig['launches']} == chunks written {n_chunks}")
    log(f"mind traced step: {json.dumps(fig['traced_step'])}")
    log(f"mind train: step times {fig['step_s']} s; peak device memory "
        f"{fig['peak_train_gb']:.2f} GB; stalls {fig['stall_s']} s; save wall_s (whole, "
        f"pipeline) {fig['save_walls']}; saves {json.dumps(saves)}; losses {fig['losses']}")
    rs, restore_s, tr2, n6, resumed = _resume_and_save(bundle, root, fig["ckpt"], 4)
    rel = float(np.abs(rs.tables["item_0"] - live["item_0"]).mean()
                / np.abs(live["item_0"]).mean())
    check(0 < rel < 0.1, f"4-bit restore error {rel} within the quantization bound")
    trained = tr2.state.params["tables"]["item_0"]
    check(not torch.equal(tr2.state.params["dense"]["routing_init"],
                          tr.state.params["dense"]["routing_init"]),
          "routing_init trained")
    launches = {k: fig["launches"][k] + resumed[k] for k in resumed}
    record_launches(kernels, "mind train", launches)
    log(f"mind restore of step 4 (chain {rs.chain_len}) {restore_s:.2f} s, mean rel err "
        f"{rel:.5f}; resumed losses {[round(h['loss'], 5) for h in tr2.history]}; step-6 "
        f"save {n6} chunks; launches {launches}")
    del tr, tr2, live, rs
    torch.cuda.empty_cache()

    p99 = get_cell("mind", "serve_p99", reduced=reduced, device=device)
    bulk = get_cell("mind", "serve_bulk", reduced=reduced, device=device)
    batches = [batch_for_cell(p99, 50_000 + i) for i in range(p99_batches)]
    bulk_np = [batch_for_cell(bulk, 60_000 + i) for i in range(bulk_batches)]
    eb.LAUNCHES.reset()
    t0 = time.monotonic()
    params, step, _ = _served_params(p99, root, device)
    answer = lambda bnd, b: bnd.step_fn(params, batch_to_device(b, bnd.device)).cpu().numpy()
    first = answer(p99, batches[0])
    first_s = time.monotonic() - t0
    check(step == 6 and first.shape == (batches[0]["hist"].shape[0],)
          and np.isfinite(first).all(), f"served from step {step}")
    _, lat = _timed_requests(lambda b: answer(p99, b), batches)
    p50, p99_ms = lat[len(lat) // 2], lat[int(len(lat) * 0.99)]
    first_bulk, bulk_lat = _timed_requests(lambda b: answer(bulk, b), bulk_np)
    n_bulk = bulk_np[0]["hist"].shape[0]
    rows_s = n_bulk * len(bulk_lat) / (sum(bulk_lat) / 1e3)
    check(first_bulk.shape == (n_bulk,) and np.isfinite(first_bulk).all(),
          "serve_bulk scores finite, one a row")
    rbundle = get_cell("mind", "retrieval_cand", reduced=reduced, device=device)
    C = rbundle.make_inputs()["candidate_ids"].shape[0]
    check(reduced or C == 1_000_000, f"retrieval_cand scores {C} candidates")
    rbatches = [batch_for_cell(rbundle, 70_000 + i) for i in range(retrieval_requests + 1)]
    rfirst, rlat = _timed_requests(lambda b: answer(rbundle, b), rbatches)
    check(rfirst.shape == (C,) and np.isfinite(rfirst).all(),
          "retrieval scores finite, one a candidate")
    check(eb.LAUNCHES.count == 0, f"no kernel in mind's forwards: {eb.LAUNCHES.count}")
    r50, r99 = rlat[len(rlat) // 2], rlat[int(len(rlat) * 0.99)]
    retrieval = dict(candidates=C, requests=retrieval_requests, p50_ms=r50, p99_ms=r99,
                     candidates_per_s=C / (r50 / 1e3))
    log(f"mind serve: restore of step {step} to the first answer {first_s:.2f} s; "
        f"serve_p99 {p99_batches} batches of {batches[0]['hist'].shape[0]}: p50 "
        f"{p50:.3f} ms, p99 {p99_ms:.3f} ms a batch (host arrays in, host scores out); "
        f"serve_bulk {len(bulk_lat)} batches of {n_bulk} after one: "
        f"{[round(t, 3) for t in bulk_lat]} ms, {rows_s:.0f} rows/s; retrieval "
        f"{json.dumps(retrieval)}")
    del params
    torch.cuda.empty_cache()
    return trained, dict(step_s=fig["step_s"], peak_train_gb=fig["peak_train_gb"],
                         saves=saves, restore_s=restore_s, first_answer_s=first_s,
                         p50_ms=p50, p99_ms=p99_ms, bulk_rows_s=rows_s,
                         retrieval=retrieval)


# ------------------------------------------------------------------ phase 8


def phase_kmeans(kernels, trained, device="cuda", rows=MIND_ITEMS, check_rows=4096):
    """The k-means quantizers (paper §4.2.2) at MIND's table shape: the
    Fig. 5 orderings at 3 bits and 8 blocks on the reference test's skewed
    rows (``tests/test_quantize.py``), made from a numpy seed at (1,000,448,
    64); the card's k-means held to the same code on the CPU over the
    first ``check_rows`` rows; each quantizer timed; and every method's
    mean row L2 on ``trained`` (MIND's trained item table), logged only: a
    table near its init is not skewed. The adaptive arm is the
    ``adaptive_quant`` kernel op, one launch a call."""
    import numpy as np
    import torch

    from repro_torch.core import (dequantize, kmeans_block_quantize,
                                  kmeans_clustered_quantize, kmeans_dequantize,
                                  kmeans_quantize, mean_l2_loss, uniform_quantize)
    from repro_torch.kernels.adaptive_quant import ops as aq

    r = np.random.default_rng(0)
    x = torch.from_numpy((r.normal(size=(rows, 64)) *
                          r.gamma(1.0, 1.0, size=(rows, 1))).astype(np.float32)).to(device)
    bits = 3
    methods = {
        "sym": lambda t: dequantize(uniform_quantize(t, bits, True)),
        "asym": lambda t: dequantize(uniform_quantize(t, bits, False)),
        "adaptive": lambda t: dequantize(aq.adaptive_quant(t, bits=bits, num_bins=25,
                                                           ratio=0.2)),
        "kmeans": lambda t: kmeans_dequantize(kmeans_quantize(t, bits)),
        "kmeans_blocks": lambda t: kmeans_dequantize(kmeans_block_quantize(t, bits, 8)),
        "kmeans_clustered": lambda t: kmeans_dequantize(
            kmeans_clustered_quantize(t, bits, 8)),
    }
    aq.ADAPTIVE_QUANT_LAUNCHES.reset()
    l2, ms = {}, {}
    for name, fn in methods.items():
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        deq = fn(x)
        end.record()
        end.synchronize()
        ms[name] = start.elapsed_time(end)
        l2[name] = float(mean_l2_loss(x, deq))
        del deq
    launches = aq.ADAPTIVE_QUANT_LAUNCHES.count
    check(launches == 1, f"adaptive_quant launches {launches}")
    check(l2["asym"] < l2["sym"] and l2["adaptive"] < l2["asym"]
          and abs(l2["kmeans"] - l2["adaptive"]) / l2["adaptive"] < 0.25
          and l2["kmeans_blocks"] > l2["asym"] and l2["kmeans_clustered"] < l2["kmeans_blocks"],
          f"Fig. 5 orderings at ({rows}, 64), 3 bits: {l2}")
    log(f"k-means at ({rows}, 64), 3 bits, 8 blocks: mean row L2 {json.dumps(l2)}; "
        f"one call each, ms (CUDA events, the first call) {json.dumps(ms)}")

    # the card against the CPU on the first rows
    xs = x[:check_rows]
    agree = {}
    for name, fn in (("kmeans", lambda t: kmeans_quantize(t, bits)),
                     ("kmeans_blocks", lambda t: kmeans_block_quantize(t, bits, 8)),
                     ("kmeans_clustered", lambda t: kmeans_clustered_quantize(t, bits, 8))):
        got, want = fn(xs), fn(xs.cpu())
        books = want.codebook.numpy()
        gb = got.codebook.cpu().numpy()
        check(np.allclose(gb, books, rtol=1e-5, atol=1e-6),
              f"{name}: card codebook vs CPU, max |d| {float(np.abs(gb - books).max())}")
        if want.block_ids is not None:
            check(torch.equal(got.block_ids.cpu(), want.block_ids), f"{name}: block ids")
            books = books[want.block_ids.numpy()]
        differ = got.codes.cpu().numpy() != want.codes.numpy()
        d = np.sort(np.abs(xs.cpu().numpy()[..., None] - books[:, None, :]), -1)
        ties = bool(np.all((d[..., 1] - d[..., 0])[differ] <= 1e-6))
        agree[name] = dict(codebook_max_abs=float(np.abs(gb - want.codebook.numpy()).max()),
                           code_diff_frac=float(differ.mean()), differ_only_at_ties=ties)
        check(differ.mean() <= 2e-3 and ties, f"{name}: card codes vs CPU {agree[name]}")
    log(f"k-means, the card vs the CPU on {check_rows} rows: {json.dumps(agree)}")
    del x, xs
    trained_l2 = {name: float(mean_l2_loss(trained, fn(trained)))
                  for name, fn in methods.items()}
    launches = aq.ADAPTIVE_QUANT_LAUNCHES.count
    check(launches == 2, f"adaptive_quant launches after the trained table {launches}")
    log(f"3-bit mean row L2 on MIND's trained item table {tuple(trained.shape)} (no "
        f"ordering asserted): {json.dumps(trained_l2)}")
    record_launches(kernels, "k-means", {"adaptive_quant": launches})
    torch.cuda.empty_cache()
    return dict(l2=l2, ms=ms, card_vs_cpu=agree, trained_l2=trained_l2)


# ------------------------------------------------------------------ phase 9


def phase_recovery_experiment(device="cuda"):
    """The CPR-versus-full loss experiment (paper §3.4) on its reduced
    dlrm-rm2 cell, on the card: ``run_experiment(device=...)``."""
    from repro_torch.train.recovery_experiment import run_experiment

    t0 = time.monotonic()
    r = run_experiment(device=device)
    wall = time.monotonic() - t0
    rec = r["cpr_recovery"]
    check(r["within_bound"], f"cpr vs full delta {r['max_cpr_vs_full_rel_delta']} "
          f"within {r['bound']}")
    check(rec.get("kind") == "partial", f"cpr recovery {rec}")
    check(0 < rec["bytes_read"] < r["full_restore_bytes"],
          f"cpr read {rec['bytes_read']} B, a full restore {r['full_restore_bytes']} B")
    out = dict(max_cpr_vs_full_rel_delta=r["max_cpr_vs_full_rel_delta"], bound=r["bound"],
               cpr_bytes_read=rec["bytes_read"], full_restore_bytes=r["full_restore_bytes"],
               cpr_wall_s=rec["wall_s"], committed_step=r["committed_step"], wall_s=wall)
    log(f"recovery experiment: {json.dumps(out)}")
    return out


# ------------------------------------------------------------------ phase 10


DIMENET_GROUPS = {"gemm": ("gemm", "nvjet", "xmma", "cutlass"),
                  "segment sums (index_put)": ("index_put", "scatter", "put_"),
                  "gathers": ("index", "gather", "embedding"),
                  "memcpy": ("memcpy",)}


def phase_dimenet(kernels, root, device="cuda", reduced=False):
    """DimeNet at full width (6 blocks, hidden 128, 8 bilinear, 7 x 6
    bases): ``molecule`` at its full shape (128 molecules of 30 atoms, 64
    edges, 256 triplets) through 4-bit adaptive saves every 2 steps (the
    95 x 128 ``species`` table, one ``quant_pack`` and one ``chunk_hash``
    launch a save), a failure, a restore and a save at 6, and energies
    served from the chain against the live model; ``minibatch_lg`` at its
    full shape (169,984 nodes, 168,960 edges, 337,920 triplets, 602
    features, 41 classes) through dense-only saves at 2 and 4 (nothing is
    tracked in graph mode), a restore and logits from it bit-equal to the
    live model's; ``full_graph_sm``, 2 steps. ``ogb_products`` is not run:
    its reckoning is logged."""
    import numpy as np
    import torch

    from repro_torch.configs import get_cell
    from repro_torch.core import CheckNRunManager, LocalFSStore
    from repro_torch.core import manifest as mf
    from repro_torch.data.cells import batch_for_cell
    from repro_torch.models import dimenet
    from repro_torch.train.loop import batch_to_device
    from repro_torch.train.state import restore_train_state

    out = {}
    # (a) molecule: saves at 2 (full) and 4, a failure, a restore, a save at 6
    bundle = get_cell("dimenet", "molecule", reduced=reduced, device=device)
    cfg, specs = bundle.cfg, bundle.make_inputs()
    check(reduced or (cfg.n_blocks, cfg.d_hidden, cfg.n_bilinear, cfg.n_spherical,
                      cfg.n_radial, cfg.n_species) == (6, 128, 8, 7, 6, 95)
          and cfg.compute_dtype == torch.bfloat16
          and specs["species"].shape == (128, 30) and specs["edge_src"].shape == (128, 64)
          and specs["tri_kj"].shape == (128, 256), "dimenet molecule at full width")
    mroot = os.path.join(root, "molecule")
    tr, live, fig = _train_phase("dimenet", bundle, mroot, device, 4, fail_at=4,
                                 groups=DIMENET_GROUPS)
    store = LocalFSStore(mroot)
    steps = mf.list_steps(store)
    check(steps == [2, 4], f"dimenet molecule committed steps {steps}")
    saves = _saved_steps(store, steps)
    n_chunks = sum(v["chunks"] for v in saves.values())
    check(saves[2]["kind"] == "full" and saves[2]["rows"] == cfg.n_species
          and saves[2]["chunks"] == 1, f"the first save is full: {saves[2]}")
    check(fig["launches"] == {"quant_pack": n_chunks, "chunk_hash": n_chunks},
          f"dimenet save launches {fig['launches']} == chunks written {n_chunks}")
    rs, restore_s, tr2, n6, resumed = _resume_and_save(bundle, mroot, fig["ckpt"], 4)
    rel, _ = _restore_error("dimenet species", rs.tables["species"], live["species"],
                            device)
    launches = {k: fig["launches"][k] + resumed[k] for k in resumed}
    record_launches(kernels, "dimenet molecule train", launches)
    params, step, _ = _served_params(bundle, mroot, device)
    b = batch_to_device(batch_for_cell(bundle, 50_000), bundle.device)
    served = dimenet.serve(params, b, cfg)
    live_e = dimenet.serve(tr2.state.params, b, cfg)
    e_rel = float((served - live_e).abs().max() / live_e.abs().max())
    check(step == 6 and served.shape == (specs["species"].shape[0],)
          and bool(torch.isfinite(served).all()) and e_rel < 0.1,
          f"energies served from step {step}: max diff {e_rel} of the live scale")
    out["molecule"] = dict(step_s=fig["step_s"], peak_train_gb=fig["peak_train_gb"],
                           traced_step=fig["traced_step"], saves=saves,
                           save_walls=fig["save_walls"], restore_s=restore_s,
                           species_rel_err=rel, served_vs_live_max_rel=e_rel,
                           launches=launches, losses=fig["losses"])
    log(f"dimenet molecule: {json.dumps(out['molecule'])}")
    del tr, tr2, live, rs, params, b
    torch.cuda.empty_cache()

    # (b) minibatch_lg: dense-only saves at 2 and 4, a restore, logits
    bundle = get_cell("dimenet", "minibatch_lg", reduced=reduced, device=device)
    specs = bundle.make_inputs()
    check(reduced or (specs["features"].shape, specs["edge_src"].shape,
                      specs["tri_kj"].shape, specs["labels"].shape, bundle.cfg.n_out)
          == ((169_984, 602), (168_960,), (337_920,), (1024,), 41),
          f"minibatch_lg at its full shape: {specs}")
    groot = os.path.join(root, "minibatch_lg")
    t0 = time.monotonic()
    batch_np = batch_for_cell(bundle, 0)
    batch_s = time.monotonic() - t0
    tr, _, fig = _train_phase("dimenet", bundle, groot, device, 4, groups=DIMENET_GROUPS)
    store = LocalFSStore(groot)
    steps = mf.list_steps(store)
    saves = _saved_steps(store, steps)
    check(steps == [2, 4] and all(v["chunks"] == 0 for v in saves.values())
          and fig["launches"] == {"quant_pack": 0, "chunk_hash": 0},
          f"minibatch_lg saves are dense-only: {saves} {fig['launches']}")
    t0 = time.monotonic()
    rs = CheckNRunManager(store, fig["ckpt"]).restore()
    restore_s = time.monotonic() - t0
    params = restore_train_state(bundle.make_state(), rs, bundle.tracked).params
    b = batch_to_device(batch_np, bundle.device)
    got = dimenet.serve(params, b, bundle.cfg)
    want = dimenet.serve(tr.state.params, b, bundle.cfg)
    check(rs.step == 4 and torch.equal(got, want) and bool(torch.isfinite(got).all()),
          "minibatch_lg logits from the restored state bit-equal to the live model's")
    out["minibatch_lg"] = dict(step_s=fig["step_s"], peak_train_gb=fig["peak_train_gb"],
                               traced_step=fig["traced_step"], saves=saves,
                               save_walls=fig["save_walls"], restore_s=restore_s,
                               batch_build_s=batch_s, losses=fig["losses"],
                               model_flops=bundle.model_flops)
    log(f"dimenet minibatch_lg: {json.dumps(out['minibatch_lg'])}")
    del tr, params, b, got, want, rs, batch_np
    torch.cuda.empty_cache()

    # (c) full_graph_sm: 2 steps
    bundle = get_cell("dimenet", "full_graph_sm", reduced=reduced, device=device)
    state = bundle.make_state()
    step_s, losses = [], []
    for i in range(2):
        b = batch_to_device(batch_for_cell(bundle, i), bundle.device)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        state, m = bundle.step_fn(state, b)
        losses.append(float(m["loss"]))
        step_s.append(round(time.monotonic() - t1, 4))
    check(all(math.isfinite(x) for x in losses), f"full_graph_sm losses {losses}")
    out["full_graph_sm"] = dict(step_s=step_s, losses=losses,
                                shape=list(bundle.make_inputs()["features"].shape))
    # (d) ogb_products: the reckoning, not a run
    E = ((61_859_140 + 511) // 512) * 512
    out["ogb_products_not_run"] = dict(
        edges=E, message_tensor_gb=E * 128 * 2 / 1e9,
        bilinear_operand_gb=E * 1 * 128 * 8 * 2 / 1e9,
        reason="one (E, h) bf16 message tensor and the (T, h * n_bilinear) bilinear "
               "operand do not fit one 80 GB card; a 512-chip cell in the reference")
    log(f"dimenet full_graph_sm and ogb_products: {json.dumps(out['full_graph_sm'])} "
        f"{json.dumps(out['ogb_products_not_run'])}")
    del state
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ phases 11 and 12


# The LM prefill layers' bar on the kernel against its plain version, per
# query row (one batch, position and head): ||got - want|| / ||want||, its
# maximum over the rows. An absolute bar cannot serve here: a causal row at
# position i averages ~i/e values of v, so its entries shrink as sqrt(e/i)
# (~0.01 at 32,768) while the first rows' stay ~1. The bar lies between the
# sound kernel's reading (0.0034 at qwen2-0.5b's layer, 0.0024 at
# nemotron-4-15b's; NVIDIA H100 80GB HBM3, 700.00 W) and the reading of
# ``_planted_fault``, the last 64 query rows without the keys of their own
# 64-key tile (0.46 and 0.43 in the same run), which a check must fail.
FLASH_ROW_BAR = 0.02


def _row_rel_err(got, want):
    """max over query rows of ||got - want|| / ||want||, (B, S, H, D) in."""
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())


def _planted_fault(q, k, v, want, tile=64):
    """The row error of a kernel that drops each row's diagonal KV tile, on
    the last ``tile`` query rows: the plain version over the keys before
    that tile, held against ``want``'s rows."""
    from repro_torch.models.layers import chunked_attention

    S = q.shape[1]
    bad = chunked_attention(q[:, S - tile:], k[:, :S - tile], v[:, :S - tile], causal=False)
    return _row_rel_err(bad, want[:, S - tile:])


def _flash_vs_plain(kernels, name, q, k, v, reps):
    """One layer's prefill attention (causal, GQA) through the tensor-core
    kernel against its plain version (``chunked_attention``, f32 inside),
    held to ``FLASH_ROW_BAR`` per query row, which the planted fault must
    exceed, and timed beside ``F.scaled_dot_product_attention`` on the same
    inputs; the comparison's launches are not the path's."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models.layers import chunked_attention

    got = fa.flash_attention_cuda(q, k, v, causal=True)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    want = chunked_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    plain_ms = (time.monotonic() - t1) * 1e3
    err = float((got.float() - want.float()).abs().max())
    row_err, fault_err = _row_rel_err(got, want), _planted_fault(q, k, v, want)
    log(f"{name} flash vs plain: max row error {row_err:.5g}, the planted fault's "
        f"{fault_err:.5g}, bar {FLASH_ROW_BAR}; max |d| {err:.4g}")
    check(row_err <= FLASH_ROW_BAR < fault_err,
          f"{name} flash vs plain: row error {row_err} <= {FLASH_ROW_BAR} < the "
          f"planted fault's {fault_err}")
    del got, want
    sdpa = lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
        enable_gqa=True)
    kern = lambda: fa.flash_attention_cuda(q, k, v, causal=True)
    B, S, Hq, D = q.shape
    b_ms, b_by = flash_bound(B, S, S, Hq, D, 2, causal=True, Hkv=k.shape[2])
    # each call between CUDA events: the profiler's traces held none of
    # these kernels at the LM shapes (16 traces in two runs), and a launch's
    # overhead is microseconds against these milliseconds; the compared
    # call above is the kernel's warm-up
    r = dict(shape=[B, S, Hq, k.shape[2], D], timed_by="CUDA events", reps=reps,
             ms=time_ms(kern, reps=reps, warmup=0),
             library_ms=time_ms(sdpa, reps=reps, warmup=1),
             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
             max_row_rel_err=row_err, planted_fault_row_rel_err=fault_err,
             row_bar=FLASH_ROW_BAR)
    lib = r["library_ms"]
    r["frac_of_bound"] = b_ms / r["ms"]
    r["vs_library"] = r["ms"] / lib
    next(k for k in kernels if k["name"] == "flash_attention").setdefault(
        "lm_prefill", {})[name] = r
    log(f"flash_attention {name} prefill layer {r['shape']} causal bf16: kernel "
        f"{r['ms']:.3f} ms ({r['timed_by']}), SDPA {lib:.3f} ms (kernel / SDPA "
        f"{r['vs_library']:.2f}), plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms "
        f"({b_by}, {100 * r['frac_of_bound']:.1f}%), max |d| vs plain {err:.4g}")
    return r


def _restore_error(name, restored, live, device):
    """A 4-bit adaptive restore of a table against its live values: the
    mean |restored - live| / mean |live|, and the same for the plain
    quantizer's own round trip of the live rows (the store keeps scale and
    zero in fp16), both on the card in chunks of 65,536 rows, summed in
    f64. The restore must add nothing beyond the quantizer's error (within
    2%); whether that is under the reference test's 0.1 depends on the
    rows: 4 bits of a Gaussian row err 0.086 at 64 wide, 0.110 at 896 and
    0.125 at 6,144 in either package (``tests/test_torch_quant_pack.py``,
    ``test_adaptive_4bit_round_trip_error_by_width``)."""
    import torch

    from repro_torch.kernels.adaptive_quant import ops as aq

    nb, ns = aq._resolve_steps("adaptive", 4, None, None)
    q_err = r_err = l_abs = 0.0
    for lo in range(0, live.shape[0], 65536):
        x = torch.from_numpy(live[lo:lo + 65536]).to(device)
        codes, scale, zero = aq._quant_torch(x, 4, nb, ns)
        deq = codes.to(torch.float32) * scale[:, None] + zero[:, None]
        q_err += float((deq - x).abs().sum(dtype=torch.float64))
        del codes, deq
        r = torch.from_numpy(restored[lo:lo + 65536]).to(device)
        r_err += float((r - x).abs().sum(dtype=torch.float64))
        l_abs += float(x.abs().sum(dtype=torch.float64))
        del x, r
    rel = r_err / l_abs
    rel_q = q_err / l_abs
    check(0 < rel <= 1.02 * rel_q, f"{name} restore error {rel} against the "
          f"quantizer's own {rel_q}")
    log(f"{name} 4-bit restore error {rel:.5f}, the quantizer's own round trip "
        f"{rel_q:.5f}; the reference test's 0.1 {'held' if rel < 0.1 else 'missed'}")
    return rel, rel_q


def _greedy_decode_vs_forward(params, cfg, prompt, n_steps, max_len):
    """Prefill ``prompt`` (the kernel), decode ``n_steps`` tokens greedily
    against a ``max_len`` cache, then one full forward over the final
    sequence (the training path's ``chunked_attention``): the max |d| of
    each step's logits from the forward's at its position, over the
    forward's logit scale."""
    import torch

    from repro_torch.models import transformer as tf

    B, P = prompt.shape
    logits_p, caches = tf.prefill_step(params, prompt, cfg)
    cache = tf.init_cache(cfg, B, max_len, device=prompt.device)
    for k in cache:
        cache[k][:, :, :P] = caches[k]
    seq, steps = prompt, [logits_p[:, -1]]
    nxt = torch.argmax(logits_p[:, -1], dim=-1).to(torch.int32)[:, None]
    for i in range(n_steps):
        seq = torch.cat([seq, nxt], dim=1)
        logits_d, cache = tf.decode_step(params, nxt, cache, P + i, cfg)
        steps.append(logits_d[:, -1])
        nxt = torch.argmax(logits_d[:, -1], dim=-1).to(torch.int32)[:, None]
    with torch.no_grad():
        ref = tf.logits_fn(params, tf.forward(params, seq, cfg)[0], cfg)
    scale = float(ref.abs().max())
    return [float((s - ref[:, P - 1 + i]).abs().max()) / scale for i, s in enumerate(steps)]


def phase_qwen2(kernels, root, device="cuda", reduced=False, train_batch=8,
                train_layers=6, prefill_batch=4, decode_steps=8, prefill_layers=2):
    """qwen2-0.5b at full width (d 896, 14 heads on 2 kv heads of 64, d_ff
    4,864, vocab 151,936) and ``train_layers`` of its 24 layers:
    ``train_4k`` at global batch ``train_batch`` of 256 (sequence 4,096)
    through 4-bit adaptive saves every 2 steps (``tok_emb``, 151,936 x 896,
    through ``quant_pack``'s narrow route), a failure, a restore and a save
    at 6; ``prefill_32k`` at batch ``prefill_batch`` of 32 (sequence 32,768)
    through the first ``prefill_layers`` of the restored params' layers
    (each layer 1.47 s of the flash kernel at this shape on an H100), every
    layer's attention one ``flash_attention`` launch, one layer's held
    against the plain version and timed beside SDPA; ``decode_32k`` at its
    full shape (batch 128, a 32,768-position cache, ``cache_len`` 16,384);
    decode against a full forward (batch 2, prompt 64, 8 greedy steps)."""
    import numpy as np
    import torch

    from repro_torch.configs import _module
    from repro_torch.configs._families import lm_cell
    from repro_torch.core import LocalFSStore
    from repro_torch.core import manifest as mf
    from repro_torch.data.cells import batch_for_cell
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import transformer as tf
    from repro_torch.models.embedding import take
    from repro_torch.models.layers import rmsnorm
    from repro_torch.train.loop import batch_to_device
    from repro_torch.tree import tree_map

    arch = "qwen2-0.5b"
    full = _module(arch).make_config(reduced=reduced)
    cfg = full if reduced else dataclasses.replace(full, n_layers=train_layers)
    cell = lambda shape, gb=None: lm_cell(arch, cfg, shape, reduced=reduced, device=device,
                                          global_batch=None if reduced else gb)
    bundle = cell("train_4k", train_batch)
    specs = bundle.make_inputs()
    check(reduced or (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
                      full.head_dim, full.d_ff, full.vocab) == (24, 896, 14, 2, 64, 4864, 151936)
          and specs["tokens"].shape == (train_batch, 4096), "qwen2-0.5b at full width")
    out = dict(params=full.param_count, params_gb_f32=full.param_count * 4 / 1e9,
               params_run=cfg.param_count,
               reduced=[f"{cfg.n_layers} of {full.n_layers} layers trained, restored and "
                        f"decoded (the smoke's time)",
                        f"train_4k global batch {specs['tokens'].shape[0]} of 256 "
                        f"(sequence kept; n_micro 1 by lm_cell's rule)",
                        f"prefill_32k batch {prefill_batch} of 32 (sequence kept)"])
    log(f"qwen2-0.5b full width: {full.param_count} parameters "
        f"({out['params_gb_f32']:.2f} GB f32), run at {cfg.n_layers} layers "
        f"({cfg.param_count}); cuts {out['reduced']}")

    # (a) train: saves at 2 (full) and 4, a failure, a restore, a save at 6
    tr, live, fig = _train_phase("qwen2-0.5b", bundle, root, device, 4, fail_at=4,
                                 trace=False)
    store = LocalFSStore(root)
    steps = mf.list_steps(store)
    check(steps == [2, 4], f"qwen2 committed steps {steps}")
    saves = _saved_steps(store, steps)
    n_chunks = sum(v["chunks"] for v in saves.values())
    check(saves[2]["kind"] == "full" and saves[2]["rows"] == cfg.vocab
          and (reduced or saves[2]["chunks"] == 3), f"the first save is full: {saves[2]}")
    check(saves[4]["kind"] != "full" and 0 < saves[4]["rows"] < cfg.vocab,
          f"the second save holds the touched rows only: {saves[4]}")
    check(fig["launches"] == {"quant_pack": n_chunks, "chunk_hash": n_chunks},
          f"qwen2 save launches {fig['launches']} == chunks written {n_chunks}")
    # one restore, the Trainer's: the manager's own of the same chain is held
    # to the Trainer's in every earlier model phase
    rs, restore_s, tr2, n6, resumed = _resume_and_save(bundle, root, fig["ckpt"], 4,
                                                       against_manager=False)
    rel, rel_q = _restore_error("qwen2-0.5b tok_emb", rs.tables["tok_emb"],
                                live["tok_emb"], device)
    launches = {k: fig["launches"][k] + resumed[k] for k in resumed}
    record_launches(kernels, "qwen2-0.5b train", launches)
    out["train"] = dict(step_s=fig["step_s"], peak_train_gb=fig["peak_train_gb"],
                        saves=saves, save_walls=fig["save_walls"], stall_s=fig["stall_s"],
                        restore_s=restore_s, tok_emb_rel_err=rel,
                        quantizer_rel_err=rel_q, launches=launches,
                        losses=fig["losses"],
                        resumed_losses=[round(h["loss"], 5) for h in tr2.history],
                        model_flops_per_step=bundle.model_flops)
    log(f"qwen2-0.5b train: {json.dumps(out['train'])}")
    del tr, tr2, live, rs
    torch.cuda.empty_cache()

    # (b) prefill from the restored params, through flash_attention
    pb = cell("prefill_32k", prefill_batch)
    params, step, _ = _served_params(pb, root, device)
    check(step == 6, f"prefill from step {step}")
    batch = batch_to_device(batch_for_cell(pb, 0), device)
    n_pre = cfg.n_layers if reduced else prefill_layers
    pcfg = dataclasses.replace(cfg, n_layers=n_pre)
    pparams = dict(tables=params["tables"], dense=dict(
        params["dense"], blocks=tree_map(lambda t: t[:n_pre], params["dense"]["blocks"])))
    out["reduced"].append(f"prefill_32k through {n_pre} of {cfg.n_layers} layers")
    fa.MMA_LAUNCHES.reset()
    torch.cuda.synchronize()
    t1 = time.monotonic()
    logits, caches = tf.prefill_step(pparams, batch["tokens"], pcfg)
    torch.cuda.synchronize()
    prefill_s = time.monotonic() - t1
    n_flash = fa.MMA_LAUNCHES.count
    B, S = batch["tokens"].shape
    check(n_flash == n_pre and logits.shape == (B, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all())
          and tuple(caches["k"].shape) == (n_pre, B, S, cfg.n_kv_heads, cfg.head_dim),
          f"prefill: {n_flash} flash launches, logits {tuple(logits.shape)}")
    del pparams
    record_launches(kernels, "qwen2-0.5b prefill", {"flash_attention": n_flash})
    del logits, caches
    torch.cuda.empty_cache()
    with torch.no_grad():
        lp = tf.layer_params(params["dense"]["blocks"], 0)
        x = take(params["tables"]["tok_emb"], batch["tokens"]).to(cfg.compute_dtype)
        pos = torch.arange(S, device=device)[None, :]
        q, k, v = tf.project_qkv(rmsnorm(x, lp["ln1"]), lp["attn"], cfg, pos)
        del x
        out["prefill"] = dict(batch=B, seq=S, layers=n_pre, s=prefill_s,
                              flash_launches=n_flash,
                              layer=_flash_vs_plain(kernels, "qwen2-0.5b", q, k, v,
                                                    reps=1))
        del q, k, v
    torch.cuda.empty_cache()
    log(f"qwen2-0.5b prefill ({B}, {S}): {prefill_s:.2f} s, {n_flash} flash launches")

    # (c) decode_32k at its full shape: the cache made on the card
    db = cell("decode_32k")
    b = batch_to_device(batch_for_cell(db, 0), device)
    cache_gb = sum(c.numel() * c.element_size() for c in b["cache"].values()) / 1e9
    cache_len, tokens = int(b["cache_len"]), b["tokens"]
    dec_s = []
    for i in range(decode_steps):
        torch.cuda.synchronize()
        t1 = time.monotonic()
        logits, _ = tf.decode_step(params, tokens, b["cache"], cache_len + i, cfg)
        torch.cuda.synchronize()
        dec_s.append(round(time.monotonic() - t1, 4))
        check(bool(torch.isfinite(logits).all()), f"decode step {i} logits finite")
        tokens = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    out["decode"] = dict(batch=tokens.shape[0], cache_positions=b["cache"]["k"].shape[2],
                         cache_len=cache_len, cache_gb=cache_gb, step_s=dec_s,
                         peak_gb=peak_gb)
    log(f"qwen2-0.5b decode_32k: {json.dumps(out['decode'])}")
    del b, logits
    torch.cuda.empty_cache()

    # (d) decode against a full forward over the same tokens, bf16
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 64)).astype(np.int32)).to(device)
    rel_d = _greedy_decode_vs_forward(params, cfg, prompt, 8, 128)
    check(rel_d[0] <= 3e-2 and max(rel_d) <= 3e-2,
          f"decode vs full forward, max |d| over the logit scale by step {rel_d}")
    out["decode_vs_forward_rel"] = rel_d
    log(f"qwen2-0.5b decode vs full forward (bf16, batch 2, prompt 64, 8 steps): max "
        f"|d| / logit scale by step {[round(x, 5) for x in rel_d]}")
    del params
    torch.cuda.empty_cache()
    return out


def phase_nemotron(kernels, root, device="cuda", reduced=False, decode_steps=16):
    """nemotron-4-15b at full width and depth (32 layers, d 6,144, 48 heads
    on 8 kv heads of 128, d_ff 24,576, vocab 256,000; 15.6 B parameters),
    made on the card in f32 (62.6 GB); not trained (parameters, gradients
    and adagrad state would take about 187 GB). Prefill at batch 1 x 4,096
    through ``flash_attention`` (one layer held against the plain version
    and timed beside SDPA), then ``decode_steps`` greedy steps against a
    32,768-position cache; then ``tok_emb`` (256,000 x 6,144, 6.29 GB) saved
    through ``CheckNRunManager`` at 4-bit adaptive — 4 chunks of 65,536 rows
    through ``quant_pack``'s wide route, the snapshot holding the table
    alone (the dense blocks are not copied to the host) — and restored
    within the 0.1 bar."""
    import numpy as np
    import torch

    from repro_torch.configs import _module
    from repro_torch.core import (CheckNRunManager, CheckpointConfig, LocalFSStore,
                                  PAPER_DEFAULTS)
    from repro_torch.core import manifest as mf
    from repro_torch.core.snapshot import take_snapshot
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels.adaptive_quant import ops as aq
    from repro_torch.kernels.chunk_hash import ops as ch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import transformer as tf
    from repro_torch.models.embedding import take
    from repro_torch.models.layers import rmsnorm

    cfg = _module("nemotron-4-15b").make_config(reduced=reduced)
    check(reduced or (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                      cfg.d_ff, cfg.vocab, cfg.act, cfg.gated)
          == (32, 6144, 48, 8, 128, 24576, 256000, "relu2", False),
          "nemotron-4-15b at full width and depth")
    S, max_len = (64, 128) if reduced else (4096, 32768)
    out = dict(params=cfg.param_count, params_gb_f32=cfg.param_count * 4 / 1e9,
               reduced=["not trained: parameters, gradients and adagrad state "
                        f"{3 * cfg.param_count * 4 / 1e9:.0f} GB",
                        f"prefill at batch 1 x {S}",
                        "the save's snapshot holds tok_emb alone: "
                        f"{(cfg.param_count - cfg.vocab * cfg.d_model) * 4 / 1e9:.1f} GB "
                        "of dense blocks not copied to the host"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    t1 = time.monotonic()
    params = tf.init_params(gen, cfg)
    torch.cuda.synchronize()
    out["init_s"] = time.monotonic() - t1
    log(f"nemotron-4-15b: {cfg.param_count} parameters ({out['params_gb_f32']:.1f} GB "
        f"f32) made on the card in {out['init_s']:.1f} s; cuts {out['reduced']}")

    # (a) prefill through flash_attention, then greedy decode
    tokens = torch.from_numpy(syn.lm_batch(syn.LMStreamConfig(
        batch=1, seq_len=S, vocab=cfg.vocab, seed=0), 0)["tokens"]).to(device)
    fa.MMA_LAUNCHES.reset()
    torch.cuda.synchronize()
    t1 = time.monotonic()
    logits, caches = tf.prefill_step(params, tokens, cfg)
    torch.cuda.synchronize()
    prefill_s = time.monotonic() - t1
    n_flash = fa.MMA_LAUNCHES.count
    check(n_flash == cfg.n_layers and bool(torch.isfinite(logits).all()),
          f"nemotron prefill: {n_flash} flash launches")
    record_launches(kernels, "nemotron-4-15b prefill", {"flash_attention": n_flash})
    cache = tf.init_cache(cfg, 1, max_len, device=device)
    cache_gb = sum(c.numel() * c.element_size() for c in cache.values()) / 1e9
    for k in cache:
        cache[k][:, :, :S] = caches[k]
    del caches
    nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    dec_s = []
    for i in range(decode_steps):
        torch.cuda.synchronize()
        t1 = time.monotonic()
        logits, cache = tf.decode_step(params, nxt, cache, S + i, cfg)
        torch.cuda.synchronize()
        dec_s.append(round(time.monotonic() - t1, 4))
        check(bool(torch.isfinite(logits).all()), f"nemotron decode step {i}")
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    out.update(prefill=dict(batch=1, seq=S, s=prefill_s, flash_launches=n_flash),
               decode=dict(cache_positions=max_len, cache_gb=cache_gb, step_s=dec_s))
    del cache, logits
    with torch.no_grad():
        lp = tf.layer_params(params["dense"]["blocks"], 0)
        x = take(params["tables"]["tok_emb"], tokens).to(cfg.compute_dtype)
        pos = torch.arange(S, device=device)[None, :]
        q, k, v = tf.project_qkv(rmsnorm(x, lp["ln1"]), lp["attn"], cfg, pos)
        del x, lp
    # the dense blocks go before the layer's timing (the profiler needs
    # room on the card) and the save (which copies the table alone)
    table = params["tables"]["tok_emb"]
    del params
    torch.cuda.empty_cache()
    out["prefill"]["layer"] = _flash_vs_plain(kernels, "nemotron-4-15b", q, k, v, reps=10)
    del q, k, v
    log(f"nemotron-4-15b prefill (1, {S}) {prefill_s:.2f} s; decode "
        f"{json.dumps(out['decode'])}")

    # (b) tok_emb saved at 4-bit adaptive through the wide route, restored
    rows = table.shape[0]
    snap = take_snapshot(1, {"tok_emb": table},
                         {"tok_emb": {"opt_acc": torch.zeros(rows, device=device)}},
                         {"tok_emb": torch.ones(rows, dtype=torch.bool, device=device)},
                         {}, {})
    del table
    torch.cuda.empty_cache()
    mgr = CheckNRunManager(LocalFSStore(root), CheckpointConfig(
        quant=PAPER_DEFAULTS[4], device=device, decode_workers=4))
    aq.LAUNCHES.reset()
    ch.LAUNCHES.reset()
    t1 = time.monotonic()
    res = mgr.save(snap).result()
    mgr.wait()
    save_s = time.monotonic() - t1
    saves = _saved_steps(LocalFSStore(root), mf.list_steps(LocalFSStore(root)))
    n = saves[1]["chunks"]
    launches = {"quant_pack": aq.LAUNCHES.count, "chunk_hash": ch.LAUNCHES.count}
    check(launches == {"quant_pack": n, "chunk_hash": n} and (reduced or n == 4),
          f"nemotron tok_emb save: {n} chunks, launches {launches}")
    record_launches(kernels, "nemotron-4-15b save", launches)
    t1 = time.monotonic()
    rs = mgr.restore()
    restore_s = time.monotonic() - t1
    mgr.close()
    check(rs.step == 1, f"nemotron restored step {rs.step}")
    rel, rel_q = _restore_error("nemotron-4-15b tok_emb", rs.tables["tok_emb"],
                                snap.tables["tok_emb"], device)
    out["save"] = dict(chunks=n, nbytes=saves[1]["nbytes"], save_s=save_s,
                       pipeline_s=res.pipeline_stats.get("wall_s"), restore_s=restore_s,
                       rel_err=rel, quantizer_rel_err=rel_q, launches=launches,
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"nemotron-4-15b tok_emb save and restore: {json.dumps(out['save'])}")
    del snap, rs
    return out



# The new LM phases' checkpoints: smaller chunks than the default 65,536
# rows and more decode threads, so a restore decodes on more of the host's
# cores at once (a chunk is decoded by one thread).
LM_CKPT = dict(chunk_rows=16384, decode_workers=6)


def _table_rows(store, step):
    """Rows a committed step wrote, by table."""
    from repro_torch.core import manifest as mf

    return {n: sum(c.n_rows for c in rec.chunks) for n, rec in mf.load(store, step).tables.items()}


def _route_launches(store, steps):
    """``quant_pack`` launches of the saves at ``steps`` by route — one a
    chunk, its route set by its table's width: narrow (<= 1,024), wide
    (<= 8,192) or long."""
    from repro_torch.core import manifest as mf

    out = {"narrow": 0, "wide": 0, "long": 0}
    for s in steps:
        for rec in mf.load(store, s).tables.values():
            out["narrow" if rec.dim <= 1024 else "wide" if rec.dim <= 8192 else "long"] += \
                len(rec.chunks)
    return out


def _prefill_1x(kernels, arch, params, cfg, device, S):
    """Prefill at batch 1 x ``S`` (synthetic tokens) through the flash
    kernel, one launch a layer; → (tokens, logits, caches, figures)."""
    import torch

    from repro_torch.data import synthetic as syn
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import transformer as tf

    tokens = torch.from_numpy(syn.lm_batch(syn.LMStreamConfig(
        batch=1, seq_len=S, vocab=cfg.vocab, seed=0), 0)["tokens"]).to(device)
    fa.MMA_LAUNCHES.reset()
    torch.cuda.synchronize()
    t1 = time.monotonic()
    logits, caches = tf.prefill_step(params, tokens, cfg)
    torch.cuda.synchronize()
    prefill_s = time.monotonic() - t1
    n_flash = fa.MMA_LAUNCHES.count
    check(n_flash == cfg.n_layers and bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (1, 1, cfg.vocab),
          f"{arch} prefill: {n_flash} flash launches for {cfg.n_layers} layers")
    record_launches(kernels, f"{arch} prefill", {"flash_attention": n_flash})
    return tokens, logits, caches, dict(batch=1, seq=S, layers=cfg.n_layers, s=prefill_s,
                                        flash_launches=n_flash)


def _layer0_qkv(params, cfg, tokens):
    """Layer 0's prefill attention inputs (q, k, v) as the forward makes
    them: GQA projections, or MLA's expanded heads with v padded."""
    import torch

    from repro_torch.models import layers as ly, transformer as tf
    from repro_torch.models.embedding import take

    with torch.no_grad():
        lp = tf.layer_params(params["dense"]["blocks"], 0)
        x = ly.rmsnorm(take(params["tables"]["tok_emb"], tokens).to(cfg.compute_dtype),
                       lp["ln1"])
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        if cfg.mla:
            parts = ly.mla_project(x, lp["mla"], cfg.mla, pos, cfg.compute_dtype)
            return ly.mla_expand(*parts, lp["mla"], cfg.n_heads, cfg.compute_dtype)
        return tf.project_qkv(x, lp["attn"], cfg, pos)


def _decode_steps(params, cfg, tokens, cache, cache_len, steps):
    """``steps`` greedy decode steps against ``cache`` from ``cache_len``;
    → the seconds of each (the card synchronized around it)."""
    import torch

    from repro_torch.models import transformer as tf

    dec_s = []
    for i in range(steps):
        torch.cuda.synchronize()
        t1 = time.monotonic()
        logits, cache = tf.decode_step(params, tokens, cache, cache_len + i, cfg)
        torch.cuda.synchronize()
        dec_s.append(round(time.monotonic() - t1, 4))
        check(bool(torch.isfinite(logits).all()), f"{cfg.name} decode step {i}")
        tokens = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    return dec_s


def _lm_train_and_restore(kernels, arch, bundle, root, device, out):
    """The LM phases' training: 4 steps with 4-bit adaptive saves at 2
    (full) and 4 (the rows touched since 2), a failure, the Trainer's
    restore at 4 and a save at 6. Checks every save's launches against its
    chunks and every restored table within 2% of the quantizer's own round
    trip; a tracked block's restored optimizer state (f32 beside the
    codes) bit-identical. → (the resumed Trainer, closed; figures)."""
    import numpy as np

    from repro_torch.core import LocalFSStore
    from repro_torch.core import manifest as mf

    tr, live, fig = _train_phase(arch, bundle, root, device, 4, fail_at=4, trace=False,
                                 ckpt_kw=LM_CKPT)
    store = LocalFSStore(root)
    steps = mf.list_steps(store)
    check(steps == [2, 4], f"{arch} committed steps {steps}")
    saves = _saved_steps(store, steps)
    n_chunks = sum(v["chunks"] for v in saves.values())
    check(saves[2]["kind"] == "full" and saves[4]["kind"] != "full",
          f"{arch}: a full save, then an increment: {saves}")
    check(fig["launches"] == {"quant_pack": n_chunks, "chunk_hash": n_chunks},
          f"{arch} save launches {fig['launches']} == chunks written {n_chunks}")
    rows = {st: _table_rows(store, st) for st in steps}
    check(rows[4]["tok_emb"] < bundle.cfg.vocab, f"{arch}: the increment's tok_emb rows")
    rs, restore_s, tr2, n6, resumed = _resume_and_save(bundle, root, fig["ckpt"], 4,
                                                       against_manager=False)
    errs = {name: _restore_error(f"{arch} {name}", rs.tables[name], live[name], device)
            for name in bundle.tracked}
    for name, sp in bundle.tracked.items():
        if sp.path[0] == "dense":
            check(np.array_equal(rs.tables[f"{name}.opt_acc2d"], live[f"{name}.opt_acc2d"]),
                  f"{arch} {name}: the restored adagrad state is the saved one, bit for bit")
    launches = {k: fig["launches"][k] + resumed[k] for k in resumed}
    record_launches(kernels, f"{arch} train", launches)
    out["train"] = dict(step_s=fig["step_s"], peak_train_gb=fig["peak_train_gb"],
                        saves=saves, rows_by_table=rows, save_walls=fig["save_walls"],
                        stall_s=fig["stall_s"], restore_s=restore_s,
                        restore_rel_err={n: e[0] for n, e in errs.items()},
                        quantizer_rel_err={n: e[1] for n, e in errs.items()},
                        launches=launches,
                        quant_pack_routes=_route_launches(store, steps + [6]),
                        losses=fig["losses"],
                        resumed_losses=[round(h["loss"], 5) for h in tr2.history],
                        model_flops_per_step=bundle.model_flops)
    log(f"{arch} train: {json.dumps(out['train'])}")
    return tr2, fig, rows


def phase_olmoe(kernels, root, device="cuda", reduced=False, layers=1, train_batch=4,
                decode_batch=16, decode_steps=4, moe_tokens=64):
    """olmoe-1b-7b at full width (d 2,048, 16 heads of 128 on 16 kv heads,
    64 experts top-8 of d_ff 1,024, vocab 50,304) through ``layers`` of its
    16 layers: ``train_4k`` at global batch ``train_batch`` (sequence 4,096)
    through 4-bit adaptive saves of ``tok_emb`` (2,048 wide: quant_pack's
    wide route) and the three expert blocks (``moe_w_up`` and
    ``moe_w_gate`` 1,024 wide: the narrow route; ``moe_w_down`` 2,048), a
    failure, a restore and a save. Each expert block's increment writes
    exactly the (layer, expert) units its interval touched, expanded to
    rows. Then, from the resumed params: prefill at 1 x 4,096 (one layer's
    flash output held to the plain version, a planted fault outside the
    bar), ``decode_32k`` at batch ``decode_batch``, greedy decode against a
    full forward, and one MoE layer on the card against the CPU."""
    import numpy as np
    import torch

    from repro_torch.configs import _module
    from repro_torch.configs._families import lm_cell
    from repro_torch.data.cells import batch_for_cell
    from repro_torch.models import layers as ly
    from repro_torch.models import transformer as tf
    from repro_torch.models.embedding import take
    from repro_torch.train.loop import batch_to_device

    arch = "olmoe-1b-7b"
    full = _module(arch).make_config(reduced=reduced)
    m = full.moe
    check(reduced or (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
                      full.head_dim, full.vocab, m.n_experts, m.top_k, m.d_ff, m.gated)
          == (16, 2048, 16, 16, 128, 50304, 64, 8, 1024, True), f"{arch} at full width")
    cfg = full if reduced else dataclasses.replace(full, n_layers=layers)
    bundle = lm_cell(arch, cfg, "train_4k", reduced=reduced, device=device,
                     global_batch=None if reduced else train_batch)
    B = bundle.make_inputs()["tokens"].shape[0]
    kv_gb = lambda b: b * 32768 * full.n_kv_heads * full.head_dim * 4 / 1e9
    out = dict(params=full.param_count, params_gb_f32=full.param_count * 4 / 1e9,
               params_run=cfg.param_count,
               reduced=[f"{cfg.n_layers} of {full.n_layers} layers: training holds f32 "
                        f"parameters, gradients and adagrad state, "
                        f"{12 * full.param_count / 1e9:.0f} GB at full depth",
                        f"train_4k global batch {B} of 256 (sequence kept)",
                        f"decode_32k batch {decode_batch} of 128: decode_attention takes "
                        f"the cache to f32 whole, {kv_gb(decode_batch):.1f} GB a layer's k "
                        f"or v at {decode_batch}, {kv_gb(128):.1f} GB at 128",
                        "prefill at batch 1 x 4,096"])
    log(f"{arch} full width: {full.param_count} parameters ({out['params_gb_f32']:.2f} GB "
        f"f32), run at {cfg.n_layers} layers ({cfg.param_count}); cuts {out['reduced']}")

    # (a) train through saves, a failure and a restore
    tr2, fig, rows = _lm_train_and_restore(kernels, arch, bundle, root, device, out)
    touched4 = fig["touched_by_step"][3]  # after step 4: the units since the save at 2
    units = {}
    for name, sp in bundle.tracked.items():
        if sp.path[0] != "dense":
            continue
        n_units = int(touched4[name].sum())
        units[name] = dict(units=sp.units, touched_since_2=n_units,
                           rows_at_2=rows[2][name], rows_at_4=rows[4][name])
        check(rows[2][name] == sp.rows and rows[4][name] == n_units * sp.expansion,
              f"{arch} {name}: the saves wrote {rows[2][name]} and {rows[4][name]} rows; "
              f"{sp.rows} and {n_units} touched units x {sp.expansion}")
    out["train"]["expert_units"] = units
    params = tr2.state.params
    del tr2
    torch.cuda.empty_cache()

    # (b) prefill through flash, one layer against the plain version
    S = 64 if reduced else 4096
    tokens, logits, caches, out["prefill"] = _prefill_1x(kernels, arch, params, cfg,
                                                         device, S)
    del logits, caches
    q, k, v = _layer0_qkv(params, cfg, tokens)
    out["prefill"]["layer"] = _flash_vs_plain(kernels, arch, q, k, v, reps=3)
    del q, k, v
    torch.cuda.empty_cache()

    # (c) decode_32k at a batch that fits
    db = lm_cell(arch, cfg, "decode_32k", reduced=reduced, device=device,
                 global_batch=None if reduced else decode_batch)
    b = batch_to_device(batch_for_cell(db, 0), device)
    out["decode"] = dict(batch=b["tokens"].shape[0], cache_positions=b["cache"]["k"].shape[2],
                         cache_len=int(b["cache_len"]),
                         cache_gb=sum(c.numel() * c.element_size()
                                      for c in b["cache"].values()) / 1e9,
                         step_s=_decode_steps(params, cfg, b["tokens"], b["cache"],
                                              int(b["cache_len"]), decode_steps),
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del b
    torch.cuda.empty_cache()
    log(f"{arch} prefill {json.dumps({k: v for k, v in out['prefill'].items() if k != 'layer'})}"
        f"; decode_32k {json.dumps(out['decode'])}")

    # (d) greedy decode against a full forward, bf16
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 64)).astype(np.int32)).to(device)
    rel_d = _greedy_decode_vs_forward(params, cfg, prompt, 8, 128)
    out["decode_vs_forward_rel"] = rel_d
    check(max(rel_d) <= 3e-2, f"{arch} decode vs full forward by step {rel_d}")

    # (e) one MoE layer on the card against the same layer on the CPU
    with torch.no_grad():
        lp = tf.layer_params(params["dense"]["blocks"], 0)
        h = ly.rmsnorm(take(params["tables"]["tok_emb"], tokens[:, :moe_tokens])
                       .to(cfg.compute_dtype), lp["ln2"])
        act = ly.act_fn(cfg.act)
        got, got_t, got_aux = ly.moe_ffn(h, lp["moe"], m, act=act,
                                         compute_dtype=cfg.compute_dtype)
        cpu_p = {k: t.cpu() for k, t in lp["moe"].items()}
        want, want_t, want_aux = ly.moe_ffn(h.cpu(), cpu_p, m, act=act,
                                            compute_dtype=cfg.compute_dtype)
        probs, _, _ = ly._moe_router(h.reshape(-1, h.shape[-1]).cpu(), cpu_p["router"],
                                     m.top_k)
        top = torch.topk(probs, m.top_k + 1, dim=-1).values
        margin = float((top[:, m.top_k - 1] - top[:, m.top_k]).min())
    scale = float(want.float().abs().max())
    err = float((got.cpu().float() - want.float()).abs().max())
    out["moe_layer_card_vs_cpu"] = dict(tokens=moe_tokens, max_abs_err=err, scale=scale,
                                        routing_margin=margin,
                                        aux=[float(got_aux), float(want_aux)])
    check(torch.equal(got_t.cpu(), want_t) and err <= 3e-2 * scale,
          f"{arch} MoE layer on the card against the CPU: {out['moe_layer_card_vs_cpu']}")
    log(f"{arch} MoE layer card vs CPU: {json.dumps(out['moe_layer_card_vs_cpu'])}; decode "
        f"vs forward by step {[round(x, 5) for x in rel_d]}")
    del params, cpu_p
    torch.cuda.empty_cache()
    return out


def phase_minicpm3(kernels, root, device="cuda", reduced=False, train_layers=2,
                   train_batch=4, decode_steps=3):
    """minicpm3-4b at full width (d 2,560, 40 heads, MLA: q_lora 768, kv_lora
    256, qk 64 + 32, v 64; d_ff 6,400, vocab 73,472): ``train_4k`` through
    ``train_layers`` of its 62 layers at global batch ``train_batch``,
    through 4-bit adaptive saves of ``tok_emb`` (2,560 wide: the wide
    route), a failure, a restore and a save. Then at full depth (4.27 B
    parameters, 17 GB f32 on the card): prefill at 1 x 4,096 through flash at
    head dim 96 (v padded from 64; one layer held to the plain version, a
    planted fault outside the bar), ``long_500k`` at its full shape (batch
    1 against a 524,288-position latent cache) for ``decode_steps`` steps,
    and greedy decode against a full forward."""
    import numpy as np
    import torch

    from repro_torch.configs import _module
    from repro_torch.configs._families import lm_cell
    from repro_torch.data.cells import batch_for_cell
    from repro_torch.models import transformer as tf
    from repro_torch.train.loop import batch_to_device

    arch = "minicpm3-4b"
    full = _module(arch).make_config(reduced=reduced)
    ml = full.mla
    check(reduced or (full.n_layers, full.d_model, full.n_heads, full.d_ff, full.vocab,
                      ml.q_lora_rank, ml.kv_lora_rank, ml.qk_nope_dim, ml.qk_rope_dim,
                      ml.v_head_dim)
          == (62, 2560, 40, 6400, 73472, 768, 256, 64, 32, 64), f"{arch} at full width")
    tcfg = full if reduced else dataclasses.replace(full, n_layers=train_layers)
    bundle = lm_cell(arch, tcfg, "train_4k", reduced=reduced, device=device,
                     global_batch=None if reduced else train_batch)
    B = bundle.make_inputs()["tokens"].shape[0]
    out = dict(params=full.param_count, params_gb_f32=full.param_count * 4 / 1e9,
               reduced=[f"train_4k through {tcfg.n_layers} of {full.n_layers} layers: "
                        f"parameters, gradients and adagrad state "
                        f"{12 * full.param_count / 1e9:.0f} GB f32 at full depth",
                        f"train_4k global batch {B} of 256 (sequence kept)",
                        "prefill at batch 1 x 4,096 (full depth)"])
    log(f"{arch} full width: {full.param_count} parameters ({out['params_gb_f32']:.2f} GB "
        f"f32); cuts {out['reduced']}")

    # (a) train at the depth cut through tok_emb saves, a failure, a restore
    tr2, _, _ = _lm_train_and_restore(kernels, arch, bundle, root, device, out)
    del tr2
    torch.cuda.empty_cache()

    # (b) full depth on the card: prefill through flash at head dim 96
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    t1 = time.monotonic()
    params = tf.init_params(gen, full)
    torch.cuda.synchronize()
    out["init_s"] = time.monotonic() - t1
    S = 64 if reduced else 4096
    tokens, logits, caches, out["prefill"] = _prefill_1x(kernels, arch, params, full,
                                                         device, S)
    check(tuple(caches["ckv"].shape) == (full.n_layers, 1, S, ml.kv_lora_rank),
          f"{arch} prefill's latent cache {tuple(caches['ckv'].shape)}")
    del logits, caches
    q, k, v = _layer0_qkv(params, full, tokens)
    check(q.shape[-1] == k.shape[-1] == v.shape[-1] == ml.qk_nope_dim + ml.qk_rope_dim
          and not v[..., ml.v_head_dim:].any(), f"{arch}: v padded to the qk head dim")
    out["prefill"]["layer"] = _flash_vs_plain(kernels, arch, q, k, v, reps=3)
    del q, k, v
    torch.cuda.empty_cache()

    # (c) long_500k at its full shape: the latent cache made on the card
    lb = lm_cell(arch, full, "long_500k", reduced=reduced, device=device)
    b = batch_to_device(batch_for_cell(lb, 0), device)
    out["long_500k"] = dict(batch=b["tokens"].shape[0],
                            cache_positions=b["cache"]["ckv"].shape[2],
                            cache_len=int(b["cache_len"]),
                            cache_gb=sum(c.numel() * c.element_size()
                                         for c in b["cache"].values()) / 1e9,
                            step_s=_decode_steps(params, full, b["tokens"], b["cache"],
                                                 int(b["cache_len"]), decode_steps),
                            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                            model_flops_per_step=lb.model_flops)
    del b
    torch.cuda.empty_cache()
    log(f"{arch} prefill {json.dumps({k: v for k, v in out['prefill'].items() if k != 'layer'})}"
        f"; long_500k {json.dumps(out['long_500k'])}")

    # (d) greedy decode against a full forward, bf16, full depth
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(1, full.vocab, (2, 64)).astype(np.int32)).to(device)
    rel_d = _greedy_decode_vs_forward(params, full, prompt, 8, 128)
    out["decode_vs_forward_rel"] = rel_d
    check(max(rel_d) <= 3e-2, f"{arch} decode vs full forward by step {rel_d}")
    log(f"{arch} decode vs full forward (bf16, {full.n_layers} layers, batch 2, prompt 64, "
        f"8 steps): max |d| / logit scale by step {[round(x, 5) for x in rel_d]}")
    del params
    torch.cuda.empty_cache()
    return out


def phase_dbrx(kernels, root, device="cuda", reduced=False, layers=1, decode_steps=4,
               routed_tokens=1):
    """dbrx-132b at full width (d 6,144, 48 heads on 8 kv heads of 128, 16
    experts top-4 of d_ff 10,752, vocab 100,352) through ``layers`` of its 40
    layers (13.0 GB f32 a layer), not trained (131.6 B parameters). Prefill
    at 1 x 4,096 (flash 48:8 at head dim 128, one layer held to the plain
    version), ``decode_steps`` greedy steps against a 32,768-position
    cache. Then the expert blocks saved through ``CheckNRunManager`` at
    4-bit adaptive — ``moe_w_up`` and ``moe_w_gate`` 10,752 wide through
    ``quant_pack``'s long route, ``moe_w_down`` 6,144 wide through the wide
    route — the snapshot holding the expert tables alone: a full save, then
    the routed experts of a forward over ``routed_tokens`` tokens changed
    and saved as an increment of exactly their units; restored within 2% of
    the quantizer's own round trip."""
    import torch

    from repro_torch.configs import _module
    from repro_torch.core import (CheckNRunManager, CheckpointConfig, LocalFSStore,
                                  PAPER_DEFAULTS)
    from repro_torch.core.snapshot import take_snapshot
    from repro_torch.kernels.adaptive_quant import ops as aq
    from repro_torch.kernels.chunk_hash import ops as ch
    from repro_torch.models import transformer as tf
    from repro_torch.train.state import tree_get

    arch = "dbrx-132b"
    full = _module(arch).make_config(reduced=reduced)
    m = full.moe
    check(reduced or (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
                      full.head_dim, full.vocab, m.n_experts, m.top_k, m.d_ff, m.gated)
          == (40, 6144, 48, 8, 128, 100352, 16, 4, 10752, True), f"{arch} at full width")
    cfg = full if reduced else dataclasses.replace(full, n_layers=layers)
    out = dict(params=full.param_count, params_gb_f32=full.param_count * 4 / 1e9,
               params_run=cfg.param_count,
               reduced=[f"{cfg.n_layers} of {full.n_layers} layers: "
                        f"{(full.param_count - cfg.param_count) * 4 / 1e9:.0f} GB f32 of "
                        f"layers not made (the card holds 80 GB)",
                        "not trained: parameters, gradients and adagrad state "
                        f"{12 * full.param_count / 1e9:.0f} GB",
                        "prefill at batch 1 x 4,096",
                        "the save's snapshot holds the expert blocks alone"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    t1 = time.monotonic()
    params = tf.init_params(gen, cfg)
    torch.cuda.synchronize()
    out["init_s"] = time.monotonic() - t1
    log(f"{arch}: {full.param_count} parameters ({out['params_gb_f32']:.1f} GB f32), "
        f"{cfg.n_layers} layers made on the card in {out['init_s']:.1f} s; cuts "
        f"{out['reduced']}")

    # (a) prefill through flash, then greedy decode against a 32,768 cache
    S, max_len = (64, 128) if reduced else (4096, 32768)
    tokens, logits, caches, out["prefill"] = _prefill_1x(kernels, arch, params, cfg,
                                                         device, S)
    cache = tf.init_cache(cfg, 1, max_len, device=device)
    for k in cache:
        cache[k][:, :, :S] = caches[k]
    del caches
    nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    out["decode"] = dict(cache_positions=max_len, step_s=_decode_steps(
        params, cfg, nxt, cache, S, decode_steps))
    del cache, logits
    q, k, v = _layer0_qkv(params, cfg, tokens)
    torch.cuda.empty_cache()
    out["prefill"]["layer"] = _flash_vs_plain(kernels, arch, q, k, v, reps=3)
    del q, k, v

    # (b) the routed units of a short forward
    with torch.no_grad():
        _, _, touched, _ = tf.forward(params, tokens[:, :routed_tokens], cfg)
    specs = {n: sp for n, sp in tf.tracked_specs(cfg).items() if sp.path[0] == "dense"}
    tables = {n: tree_get(params, sp.path).reshape(sp.rows, sp.dim) for n, sp in specs.items()}
    del params
    torch.cuda.empty_cache()
    units = touched.reshape(-1)
    n_units = int(units.sum())
    check(0 < n_units < units.numel(), f"{arch}: a forward over {routed_tokens} tokens "
          f"routed to {n_units} of {units.numel()} (layer, expert) units")

    # (c) the expert blocks saved: full, then the routed units changed and
    # saved as an increment; restored
    mgr = CheckNRunManager(LocalFSStore(root), CheckpointConfig(
        quant=PAPER_DEFAULTS[4], device=device, policy="one_shot", **LM_CKPT))
    aq.LAUNCHES.reset()
    ch.LAUNCHES.reset()
    every = {n: torch.ones(sp.rows, dtype=torch.bool, device=device)
             for n, sp in specs.items()}
    t1 = time.monotonic()
    snap = take_snapshot(1, tables, {n: {} for n in specs}, every, {}, {})
    res1 = mgr.save(snap).result()
    mgr.wait()
    save1_s = time.monotonic() - t1
    del snap, every
    with torch.no_grad():
        for n, sp in specs.items():
            view = tables[n].view(sp.units, sp.expansion, sp.dim)
            view[units] *= 1.01
    rows_mask = {n: units.repeat_interleave(sp.expansion) for n, sp in specs.items()}
    t1 = time.monotonic()
    snap = take_snapshot(2, tables, {n: {} for n in specs}, rows_mask, {}, {})
    res2 = mgr.save(snap).result()
    mgr.wait()
    save2_s = time.monotonic() - t1
    del tables, rows_mask
    torch.cuda.empty_cache()
    store = LocalFSStore(root)
    rows = {st: _table_rows(store, st) for st in (1, 2)}
    saves = _saved_steps(store, [1, 2])
    n = saves[1]["chunks"] + saves[2]["chunks"]
    launches = {"quant_pack": aq.LAUNCHES.count, "chunk_hash": ch.LAUNCHES.count}
    check(launches == {"quant_pack": n, "chunk_hash": n},
          f"{arch} expert saves: {n} chunks, launches {launches}")
    check(res2.kind == "incremental", f"{arch} second save {res2.kind}")
    for name, sp in specs.items():
        check(rows[1][name] == sp.rows and rows[2][name] == n_units * sp.expansion,
              f"{arch} {name}: {rows[1][name]} and {rows[2][name]} rows saved; "
              f"{sp.rows}, then {n_units} routed units x {sp.expansion}")
    record_launches(kernels, f"{arch} expert saves", launches)
    t1 = time.monotonic()
    rs = mgr.restore()
    restore_s = time.monotonic() - t1
    mgr.close()
    check(rs.step == 2, f"{arch} restored step {rs.step}")
    errs = {name: _restore_error(f"{arch} {name}", rs.tables[name], snap.tables[name], device)
            for name in specs}
    out["save"] = dict(routed_tokens=routed_tokens, routed_units=n_units,
                       units=units.numel(), rows_by_table=rows, saves=saves,
                       save_s=[save1_s, save2_s],
                       pipeline_s=[res1.pipeline_stats.get("wall_s"),
                                   res2.pipeline_stats.get("wall_s")],
                       restore_s=restore_s,
                       restore_rel_err={n: e[0] for n, e in errs.items()},
                       quantizer_rel_err={n: e[1] for n, e in errs.items()},
                       launches=launches, quant_pack_routes=_route_launches(store, [1, 2]),
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"{arch} prefill {json.dumps({k: v for k, v in out['prefill'].items() if k != 'layer'})}"
        f"; decode {json.dumps(out['decode'])}; expert saves and restore "
        f"{json.dumps(out['save'])}")
    del snap, rs
    return out



# ------------------------------------------------------------------ phase 16

DRYRUN_TABLE = os.path.join(HERE, "tests", "dryrun_reference_bytes.json")
DRYRUN_COLLECTIVES = os.path.join(HERE, "tests", "dryrun_collectives.json")


def _kernel_counters():
    """Every kernel's launch counter."""
    from repro_torch.kernels.adaptive_quant import ops as aq
    from repro_torch.kernels.chunk_hash import ops as ch
    from repro_torch.kernels.dot_interaction import ops as di
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.flash_attention import ops as fa

    return {"quant_pack": aq.LAUNCHES, "adaptive_quant": aq.ADAPTIVE_QUANT_LAUNCHES,
            "chunk_hash": ch.LAUNCHES, "embedding_bag": eb.LAUNCHES,
            "dot_interaction": di.LAUNCHES, "flash_attention_mma": fa.MMA_LAUNCHES,
            "flash_attention_f32": fa.SIMT_LAUNCHES}


def _no_kernel_path(counters, what):
    counts = {k: c.count for k, c in counters.items()}
    check(not any(counts.values()), f"{what} runs no hand-written kernel: {counts}")


def phase_dryrun(root):
    """The dry run's CLI over the 40 cells on both production meshes, in
    this process: a line a cell with its per-device GB against the card's
    memory; each cell's bytes (state or params, and inputs) equal to the
    reference's table; the collectives of the cells it counts equal to the
    CPU's count (``tests/dryrun_collectives.json``), null with a reason
    elsewhere; no memory taken on the card."""
    import torch

    from repro_torch.configs import all_cells
    from repro_torch.launch import dryrun

    counters = _kernel_counters()
    for c in counters.values():
        c.reset()
    with open(DRYRUN_TABLE) as f:
        table = json.load(f)
    with open(DRYRUN_COLLECTIVES) as f:
        coll_table = json.load(f)
    card = torch.cuda.get_device_properties(0).total_memory
    allocated = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    out = {}
    counted = {"16x16": {}, "2x16x16": {}}  # MB of collectives a device and step
    for mesh, tag, flag in (("16x16", "pod", []), ("2x16x16", "multipod", ["--multi-pod"])):
        d = os.path.join(root, mesh)
        check(dryrun.main(["--all", "--out", d] + flag) == 0, f"dry run on {mesh}")
        fits = 0
        for arch, shape in all_cells():
            with open(os.path.join(d, f"dryrun_{arch}_{shape}_{tag}.json")) as f:
                rec = json.load(f)
            split = rec["memory"]["argument_split"]
            got = dict(tree=split.get("state", split.get("params")), inputs=split["inputs"])
            want = table[mesh][f"{arch}/{shape}"]
            check(got == want, f"dry run {arch} {shape} {mesh}: bytes {got} == the "
                  f"reference's {want}")
            check(rec["card_bytes"] == card
                  and rec["fits_card"] == (rec["memory"]["argument_size"] <= card),
                  f"{arch} {shape} {mesh} against the card's {card} B")
            fits += rec["fits_card"]
            key = f"{arch}/{shape}"
            check(rec["collectives"] == coll_table[mesh].get(key) and rec["collectives_note"],
                  f"dry run {arch} {shape} {mesh}: collectives as counted on the CPU")
            if rec["collectives"] is not None:
                counted[mesh][key] = round(rec["collectives"]["total"] / 1e6, 3)
        top = max(all_cells(), key=lambda c: sum(table[mesh][f"{c[0]}/{c[1]}"].values()))
        out[mesh] = dict(cells=len(all_cells()), fit_the_card=fits,
                         largest=f"{top[0]} {top[1]}",
                         largest_gb=sum(table[mesh][f"{top[0]}/{top[1]}"].values()) / 1e9,
                         collectives_mb_a_device=counted[mesh])
    check(torch.cuda.memory_allocated() == allocated, "the dry run took no card memory")
    _no_kernel_path(counters, "the dry run")
    out.update(card_gb=card / 1e9, seconds=round(time.monotonic() - t0, 2))
    log(f"dry run: {json.dumps(out)}")
    return out


# ------------------------------------------------------------------ phase 17

EP_DATA, EP_MODEL = 2, 2
EP_TOKENS = 4096  # a rank's tokens
EP_SKEW = 0.5


def _ep_inputs(device, reduced):
    """olmoe-1b-7b's MoE config (the reduced one when ``reduced``), its
    layer's params and the (data, tokens, d) bf16 input, drawn on
    ``device`` from one seed: every process that calls this holds the same
    numbers. The tokens share a component (``EP_SKEW`` times one normal
    vector), which loads the experts unevenly, as a trained layer's
    routing does: at the default φ the busiest experts overflow, and the
    phase checks that some pairs drop."""
    import torch

    from repro_torch.configs import _module
    from repro_torch.models.layers import moe_params_init

    cfg = _module("olmoe-1b-7b").make_config(reduced=reduced)
    gen = torch.Generator(device=device)
    gen.manual_seed(17)
    params = moe_params_init(gen, cfg.d_model, cfg.moe)
    n = 64 if reduced else EP_TOKENS
    x = torch.randn((EP_DATA, n, cfg.d_model), generator=gen, device=device)
    x += EP_SKEW * torch.randn((cfg.d_model,), generator=gen, device=device)
    return cfg.moe, params, x.to(torch.bfloat16)


def _ep_capacity(moe, n, phi):
    return min(max(int(phi * n * moe.top_k / moe.n_experts), 8), n)


def ep_worker(argv) -> int:
    """One rank of phase 17: joins the gloo group, lays the 2 x 2 mesh,
    runs its batch shard through ``moe_ffn(dispatch="ep")`` at φ = E / k
    (nothing drops) and at the default φ, saves its outputs under ``root``,
    runs the sharded DimeNet (``dimenet_worker``), the row-sharded recsys
    cells (``recsys_worker``) and the LM train cells (``lm_worker``) and
    prints its figures as a JSON line."""
    import datetime

    import torch
    import torch.distributed as dist

    rank, world, port, root, device, reduced = argv
    rank, world, reduced = int(rank), int(world), reduced == "1"
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        from repro_torch.dist.sharding import lm_rules
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models.layers import _moe_router, moe_ffn

        mesh = make_host_mesh(EP_DATA, EP_MODEL)
        i, j = mesh.axis_index("data"), mesh.axis_index("model")
        moe, params, x = _ep_inputs(device, reduced)
        x_l = x[i:i + 1]
        rules = lm_rules(mesh)
        e_l = moe.n_experts // EP_MODEL
        _, _, ids = _moe_router(x_l[0], params["router"], moe.top_k)
        # the rank holds the router and its own experts, as a shard_map cell does
        params = dict(router=params["router"], **{
            k: params[k][j * e_l:(j + 1) * e_l] for k in ("w_up", "w_gate", "w_down")})
        counts = torch.bincount(ids.reshape(-1), minlength=moe.n_experts)[j * e_l:(j + 1) * e_l]
        rec = dict(rank=rank, data=i, model=j, tokens=x_l.shape[1])
        for name, phi in (("nodrop", moe.n_experts / moe.top_k), ("default", moe.capacity_factor)):
            cfg = dataclasses.replace(moe, capacity_factor=phi, dispatch="ep")
            cap = _ep_capacity(moe, x_l.shape[1], phi)
            y, touched, aux = moe_ffn(x_l, params, cfg, compute_dtype=torch.bfloat16,
                                      rules=rules)
            ms = []
            for _ in range(3):
                dist.barrier()
                t0 = time.monotonic()
                moe_ffn(x_l, params, cfg, compute_dtype=torch.bfloat16, rules=rules)
                if device == "cuda":
                    torch.cuda.synchronize()
                ms.append((time.monotonic() - t0) * 1e3)
            torch.save(dict(y=y.cpu(), touched=touched.cpu(), aux=aux.cpu()),
                       os.path.join(root, f"ep_{name}_{rank}.pt"))
            rec[name] = dict(capacity=cap, dropped=int((counts - cap).clamp(min=0).sum()),
                             ms=round(statistics.median(ms), 3))
        del params, x, x_l, y
        rec["dimenet"] = dimenet_worker(mesh, root, device, reduced)
        rec["recsys"] = recsys_worker(mesh, root, device, reduced)
        rec["lm"] = lm_worker(root, device, reduced)
        print(json.dumps(rec), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


# The sharded DimeNet's bars on the card, bf16 at full width. The CPU
# tests' largest bf16 readings (tests/test_torch_dimenet_sharded.py, the
# reduced config): rows 0.030 of a row's scale between the port and the
# reference, whose GEMMs round differently (0.0 between the port's sharded
# and plain forwards, which share them on the CPU); summed gradients
# 0.0065 of a leaf's largest entry between the sharded and the plain
# backward (2 x 2 mesh, reduced minibatch_lg and full_graph_sm). On the
# card the two sides' GEMMs differ in their row counts, so cuBLAS may
# round them differently too: the bars take the rows' reading with a
# margin of 1.7 and the gradients' with one of 7.7.
DN_ROW_BAR = 0.05    # of a row's scale (its largest |entry|)
DN_GRAD_BAR = 0.05   # of a leaf's largest |entry|
DN_TIMED_STEPS = 3


def _dimenet_batch_path(root):
    return os.path.join(root, "dimenet_minibatch_lg.npz")


def _row_scale_err(got, want) -> float:
    """max over rows of max |got - want| / max |want| in the row."""
    got, want = got.float(), want.float()
    return float(((got - want).abs().amax(1) / want.abs().amax(1).clamp_min(1e-30)).max())


def dimenet_worker(mesh, root, device, reduced) -> dict:
    """One rank's sharded DimeNet (phase 17): ``minibatch_lg`` (reduced when
    ``reduced``) at full width, the batch this process's parent wrote.
    (a) The rank's rows of ``forward_flat_sharded``, gathered to every
    rank, against rank 0's ``forward_flat`` of the batch with the clamp
    applied, and of the batch as drawn (which must miss the bar: the check
    can fail). (b) The summed gradients of ``train_loss`` against the same
    plain batch's backward, on rank 0. (d) One train step's recorded
    collectives against the dry run's count for the cell on this mesh's
    shape, then the step timed, and its collectives alone (each call
    replayed at its size). (c) ``launch.train.main --mesh 2x2`` in
    this process's group: 4 steps with dense-only saves every 2 and a
    failure at 3, then the rerun resuming from the one chain. No
    hand-written kernel runs: the counters stay 0."""
    import io
    from contextlib import redirect_stdout

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_cell
    from repro_torch.dist.group_ops import all_gather, all_reduce, recording, reduce_scatter
    from repro_torch.launch import dryrun, train
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import dimenet as dn
    from repro_torch.train.loop import batch_to_device
    from repro_torch.train.steps import sum_grads
    from repro_torch.tree import tree_map

    counters = _kernel_counters()
    for c in counters.values():
        c.reset()
    rank = dist.get_rank()
    dev = device if device == "cpu" else f"cuda:{rank % torch.cuda.device_count()}"

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    path = _dimenet_batch_path(root)
    t0 = time.monotonic()
    while not os.path.exists(path + ".done"):
        check(time.monotonic() - t0 < 300, "the parent wrote the dimenet batch")
        time.sleep(0.2)
    bundle = get_cell("dimenet", "minibatch_lg", reduced=reduced, device=dev, mesh=mesh)
    batch = batch_to_device(dict(np.load(path)), dev)
    cfg, rules, n = bundle.cfg, bundle.rules, mesh.size
    group = mesh.group_for(("data", "model"))
    check(dn._use_sharded(batch, cfg, rules), "minibatch_lg shards over the 2 x 2 mesh")
    state = bundle.make_state(17)
    params = state.params
    kj, ji = dn.clamp_remap(batch, n)
    out = dict(moved=float(((kj != batch["tri_kj"]) | (ji != batch["tri_ji"]))
                           .to(torch.float32).mean()))
    clamped = dict(batch, tri_kj=kj, tri_ji=ji)

    # (a) rows
    with torch.no_grad():
        every = all_gather(dn.forward_flat_sharded(params, batch, cfg, rules), group)
        if rank == 0:
            want = dn.forward_flat(params, clamped, cfg)
            out.update(finite=bool(torch.isfinite(every).all()),
                       row_err=_row_scale_err(every, want),
                       row_err_unclamped=_row_scale_err(every, dn.forward_flat(params, batch, cfg)))
            del want
    del every

    # (b) gradients: the ranks' sum against the plain backward
    def grads(b, r):
        leaves = []

        def track(t):
            leaves.append(t.detach().requires_grad_(True))
            return leaves[-1]

        loss, _ = dn.train_loss(tree_map(track, params), b, cfg, r)
        return float(loss), list(torch.autograd.grad(loss, leaves))

    loss_s, g_s = grads(batch, rules)
    g_s = sum_grads(g_s, group)
    if rank == 0:
        loss_p, g_p = grads(clamped, dn.NO_SHARDING)
        out.update(loss=[loss_s, loss_p], grad_err=max(
            float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(g_s, g_p)))
        del g_p
    del g_s
    if device == "cuda":
        torch.cuda.empty_cache()

    # (d) one step's collectives against the dry run's count; the step's time
    with recording() as r:
        bundle.step_fn(state, batch)
    got = r.summary()
    want, _ = dryrun.count_collectives("dimenet", "minibatch_lg", Mesh(dict(mesh.shape)),
                                       reduced=reduced)
    ms = []
    for _ in range(DN_TIMED_STEPS):
        dist.barrier()
        sync()
        t1 = time.monotonic()
        bundle.step_fn(state, batch)
        sync()
        ms.append((time.monotonic() - t1) * 1e3)
    # the step's collectives alone: each call replayed at its size and dtype
    ops = dict(zip(("all-gather", "reduce-scatter", "all-reduce"),
                   (all_gather, reduce_scatter, all_reduce)))
    coll_ms = []
    for _ in range(2):
        dist.barrier()
        sync()
        t1 = time.monotonic()
        for c in r.calls:
            ops[c.op](torch.zeros(c.operand_bytes // c.dtype.itemsize, dtype=c.dtype,
                                  device=dev), group)
        sync()
        coll_ms.append((time.monotonic() - t1) * 1e3)
    out.update(count_equal=got == want, counts=got["counts"], bytes=got["total"],
               wire_bytes=got["wire_total"], step_ms=[round(x, 2) for x in ms],
               collectives_ms=round(min(coll_ms), 2))
    del state, params, batch, clamped
    if device == "cuda":
        torch.cuda.empty_cache()

    # (c) training through the launcher, a failure, a resume
    cmd = ["--arch", "dimenet", "--shape", "minibatch_lg", "--mesh", "2x2", "--steps", "4",
           "--interval", "2", "--device", device, "--ckpt-dir", os.path.join(root, "dimenet-ckpt")]
    if not reduced:
        cmd.append("--full-config")
    rcs, logs = [], []
    t1 = time.monotonic()
    for extra in (["--fail-at", "3"], []):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rcs.append(train.main(cmd + extra))
        logs.append(buf.getvalue())
    out.update(launcher_rcs=rcs, launcher_s=round(time.monotonic() - t1, 2),
               launcher_log=logs if rank == 0 else None,
               launches={k: c.count for k, c in counters.items()})
    return out


def _moe_capacity_plain(x_l, params, moe, cap, cd):
    """The capacity rule, plainly, on one batch shard (n, d): the router
    (f32 softmax, top-k, the weights renormalized) and the aux loss written
    out here, then every expert of the layer in turn takes the first
    ``cap`` of the tokens routed to it, in token order, and adds their
    gated outputs. → (out (n, d) f32, the routed ids, the shard's aux
    loss)."""
    import torch
    import torch.nn.functional as F

    E, k = moe.n_experts, moe.top_k
    probs = torch.softmax(x_l.to(torch.float32) @ params["router"].to(torch.float32), -1)
    w, ids = torch.topk(probs, k, dim=-1)
    w = w / w.sum(-1, keepdim=True)
    first = torch.zeros_like(probs).scatter_(1, ids[:, :1], 1.0)
    aux = E * torch.sum(probs.mean(0) * first.mean(0))
    out = torch.zeros(x_l.shape, dtype=torch.float32, device=x_l.device)
    for e in range(E):
        hit = ids == e
        rows = torch.nonzero(hit.any(-1)).flatten()[:cap]
        g = (w * hit).sum(-1)[rows]
        xs = x_l[rows].to(cd)
        h = F.silu(xs @ params["w_gate"][e].to(cd)).to(cd) * (xs @ params["w_up"][e].to(cd))
        out[rows] += (h @ params["w_down"][e].to(cd)).to(torch.float32) * g[:, None]
    return out, ids, aux


EP_DENSE_BAR = 2 ** -6  # ep (bf16 products) vs dense (f32 products), of the row scale
EP_PLAIN_BAR = 2 ** -7  # ep vs the plain capacity rule: bf16 products of other shapes


def phase_moe_ep(root, device="cuda", reduced=False, one_process_step_s=None, kernels=None):
    """The mesh over 4 processes on the one card (2 x 2 mesh, gloo at
    127.0.0.1). Expert-parallel MoE: each rank's output against this
    process's dense dispatch of its batch shard where nothing drops, and
    against the plain capacity rule at the default φ; touched masks and
    aux losses against the shards' routing. Then each rank's sharded
    DimeNet (``dimenet_worker``) on the ``minibatch_lg`` batch this process
    writes while the ranks start; its figures beside phase 10's
    one-process step (``one_process_step_s``). Then the row-sharded recsys
    cells (``recsys_worker``) and the LM train cells (``lm_worker``); rank
    0's save launches go into ``kernels``. A rank that fails fails the
    phase."""
    import socket

    import numpy as np
    import torch

    from repro_torch.configs import get_cell
    from repro_torch.data.cells import batch_for_cell
    from repro_torch.models.layers import moe_ffn

    counters = _kernel_counters()
    for c in counters.values():
        c.reset()
    t0 = time.monotonic()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    world = EP_DATA * EP_MODEL
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"), OMP_NUM_THREADS="1")
    code = (f"import sys; sys.path.insert(0, {HERE!r}); import chip_smoke; "
            f"sys.exit(chip_smoke.ep_worker(sys.argv[1:]))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), str(port),
                               root, device, "1" if reduced else "0"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=HERE)
             for r in range(world)]
    try:
        # the sharded DimeNet's batch: one build (the node features are
        # phase 10's, cached) for the 4 ranks, which read it after the EP check
        path = _dimenet_batch_path(root)
        np.savez(path, **batch_for_cell(get_cell("dimenet", "minibatch_lg", reduced=reduced,
                                                 device=device), 0))
        open(path + ".done", "w").close()
        moe, params, x = _ep_inputs(device, reduced)
        cd = torch.bfloat16
        dense, plain = [], []
        for i in range(EP_DATA):
            cfg = dataclasses.replace(moe, dispatch="dense")
            if device == "cuda":
                torch.cuda.synchronize()
            t1 = time.monotonic()
            y, _, _ = moe_ffn(x[i:i + 1], params, cfg, compute_dtype=cd)
            if device == "cuda":
                torch.cuda.synchronize()
            dense.append((y[0].to(torch.float32), (time.monotonic() - t1) * 1e3))
            cap = _ep_capacity(moe, x.shape[1], moe.capacity_factor)
            plain.append(tuple(t.cpu() for t in _moe_capacity_plain(x[i], params, moe, cap, cd)))
        # the ranks' row-sharded cells want the card's memory: this process
        # keeps its results on the host
        dense = [(y.cpu(), ms) for y, ms in dense]
        del params, x, y
        if device == "cuda":
            torch.cuda.empty_cache()
        outs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    failed = [f"rank {r} exited {p.returncode}: {e[-2500:]}"
              for r, (p, (o, e)) in enumerate(zip(procs, outs)) if p.returncode != 0]
    check(not failed, "mesh ranks failed:\n" + "\n".join(failed))
    ranks = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    touched_want = torch.zeros(moe.n_experts, dtype=torch.bool)
    for _, ids, _ in plain:
        touched_want[ids.reshape(-1).cpu()] = True
    aux_want = float(sum(a for _, _, a in plain)) / EP_DATA
    errs = {}
    for rec in ranks:
        r, i = rec["rank"], rec["data"]
        for name in ("nodrop", "default"):
            got = torch.load(os.path.join(root, f"ep_{name}_{r}.pt"))
            want = dense[i][0] if name == "nodrop" else plain[i][0]
            want = want.cpu()
            y = got["y"][0].to(torch.float32)
            scale = float(want.abs().max())
            err = float((y - want).abs().max()) / scale
            bar = EP_DENSE_BAR if name == "nodrop" else EP_PLAIN_BAR
            errs[f"{name} rank {r}"] = err
            check(torch.isfinite(y).all() and err <= bar,
                  f"ep {name} rank {r}: max error {err:.3e} of the row scale <= {bar}")
            twin = torch.load(os.path.join(root, f"ep_{name}_{i * EP_MODEL}.pt"))
            check(torch.equal(got["y"], twin["y"]), f"ep {name}: the model ranks of batch "
                  f"shard {i} hold one sum")
            check(torch.equal(got["touched"], touched_want), f"ep {name} rank {r} touched")
            check(abs(float(got["aux"]) - aux_want) <= 1e-5 * max(abs(aux_want), 1.0),
                  f"ep {name} rank {r} aux {float(got['aux'])} vs {aux_want}")
        check(rec["nodrop"]["dropped"] == 0, f"rank {r} dropped at φ = E / k: {rec}")
    check(sum(rec["default"]["dropped"] for rec in ranks) > 0,
          f"the default φ dropped tokens, so the capacity rule is exercised: {ranks}")
    _no_kernel_path(counters, "the dense and plain MoE")
    dn_ranks = [rec.pop("dimenet") for rec in ranks]
    rs_ranks = [rec.pop("recsys") for rec in ranks]
    lm_ranks = [rec.pop("lm") for rec in ranks]
    out = dict(card=card_name(), ranks=ranks, max_rel_err=errs,
               dense_ms=[round(ms, 3) for _, ms in dense],
               tokens_dropped={f"rank {rec['rank']}": rec["default"]["dropped"]
                               for rec in ranks},
               seconds=round(time.monotonic() - t0, 2))
    log(f"moe ep: {json.dumps(out)}")
    out["dimenet"] = _check_dimenet_ranks(dn_ranks, one_process_step_s)
    out["recsys"] = _check_recsys_ranks(rs_ranks, kernels)
    out["lm"] = _check_lm_ranks(lm_ranks, kernels)
    return out


def _check_dimenet_ranks(dn, one_process_step_s):
    """Phase 17's checks of the ranks' sharded DimeNet records, and its
    log lines."""
    r0 = dn[0]
    check(r0["finite"] and r0["row_err"] <= DN_ROW_BAR,
          f"sharded dimenet rows vs rank 0's forward_flat of the clamped batch: "
          f"{r0['row_err']:.3e} of the row scale <= {DN_ROW_BAR}")
    check(r0["row_err_unclamped"] > DN_ROW_BAR,
          f"the batch as drawn gives other rows ({r0['row_err_unclamped']:.3e}): "
          f"the check can fail")
    loss_s, loss_p = r0["loss"]
    check(r0["grad_err"] <= DN_GRAD_BAR and abs(loss_s - loss_p) <= DN_GRAD_BAR * abs(loss_p),
          f"summed gradients vs the plain backward: {r0['grad_err']:.3e} of a leaf's "
          f"largest <= {DN_GRAD_BAR}; loss {loss_s} vs {loss_p}")
    for r, rec in enumerate(dn):
        check(rec["launcher_rcs"] == [2, 0], f"rank {r}: launcher --mesh fail then resume "
              f"{rec['launcher_rcs']}")
        check(rec["count_equal"], f"rank {r}: one step's collectives equal the dry run's "
              f"count: {rec['counts']}")
        check(rec["moved"] == r0["moved"] and rec["bytes"] == r0["bytes"],
              f"rank {r} moved and bytes as rank 0's")
        check(not any(rec["launches"].values()), f"rank {r}: the sharded dimenet runs no "
              f"hand-written kernel: {rec['launches']}")
    first, second = r0["launcher_log"]
    check("resumed from checkpoint at step 2" in second
          and "parameters bit-equal after every step and the restore" in second,
          f"the rerun resumed from the one chain, ranks bit-equal: {second[-500:]}")
    step_ms = [statistics.median(rec["step_ms"]) for rec in dn]
    one = (statistics.median(one_process_step_s[1:]) * 1e3
           if one_process_step_s and len(one_process_step_s) > 1 else None)
    out = dict(card=card_name(), clamp_moved_share=r0["moved"], row_err=r0["row_err"],
               row_err_unclamped=r0["row_err_unclamped"], grad_err=r0["grad_err"],
               loss_sharded_plain=r0["loss"], step_ms_by_rank=[round(x, 2) for x in step_ms],
               one_process_step_ms=None if one is None else round(one, 2),
               collectives_ms_by_rank=[rec["collectives_ms"] for rec in dn],
               bytes_a_step=r0["bytes"], wire_bytes_a_step=r0["wire_bytes"],
               counts_a_step=r0["counts"], launcher_s=[rec["launcher_s"] for rec in dn])
    log(f"dimenet sharded: {json.dumps(out)}")
    return out


# Row-sharded tables (phase 17 since PR 28): the recsys train cells and
# dimenet's molecule, one mesh step each held to one process's step of the
# same state on the card, at the bars of the reference's own mesh test
# (tests/test_distribution.py: the loss within 1e-4, the tables rtol 1e-3,
# atol 1e-5), the tables' accumulators at the same bars, the touched masks
# equal. dlrm-rm2's vocabularies capped as phase 3's.
RS_CELLS = (("dlrm-rm2", "train_batch"), ("xdeepfm", "train_batch"),
            ("mind", "train_batch"), ("bert4rec", "train_batch"), ("dimenet", "molecule"))
RS_VOCAB_CAP = 2 ** 20
# four ranks on one card each hold half of a batch, twice one process's
# activations, so two global batches are cut to the largest power of two
# that fits (my chip runs, PR 28): xdeepfm's CIN at 32,768 rows a rank
# missed by 4.76 GiB; bert4rec's 8,192 sequences a rank (65,536 in 4
# micro-batches, or 16,384 whole) by 4.88 GiB, and 32,768 takes no
# micro-batches (the reference's rule), so 8,192 (4,096 a rank). The
# micro-batched mesh step is held to the reference on the CPU
# (tests/test_torch_mesh_recsys.py, 65,536 at reduced width).
RS_BATCH = {"xdeepfm": 32768, "bert4rec": 8192}
RS_LOSS_BAR = 1e-4
RS_RTOL, RS_ATOL = 1e-3, 1e-5


def _timed_collectives():
    """Wrap ``dist.group_ops``' raw collectives so each adds its wall time
    (between device synchronizations) to the returned list's sum; returns
    (the seconds list, a function that unwraps them)."""
    import torch

    from repro_torch.dist import group_ops as go

    spent = [0.0]
    saved = {name: getattr(go, name) for name in ("_gather", "_scatter", "_sum")}

    def timed(fn):
        def run(*a, **kw):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t0 = time.monotonic()
            out = fn(*a, **kw)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            spent[0] += time.monotonic() - t0
            return out
        return run

    for name, fn in saved.items():
        setattr(go, name, timed(fn))
    return spent, lambda: [setattr(go, n, f) for n, f in saved.items()]


def _table_leaves(state):
    """{key: host tensor} of the tables, their accumulators and touched
    masks, and bert4rec's row-sharded ``out_bias`` with its accumulator."""
    from repro_torch.tree import flatten_with_path, keystr

    out = {}
    for tag in ("params", "opt_state", "touched"):
        for path, leaf in flatten_with_path(getattr(state, tag)):
            key = tag + keystr(path)
            if tag == "touched" or "tables" in key or "out_bias" in key:
                out[key] = leaf.detach().to("cpu")
    return out


def _recsys_cell(arch, shape, mesh, device, dev, reduced) -> dict:
    """One cell of ``recsys_worker``: rank 0 steps the whole state in one
    process; then every rank steps its part on the mesh (recorded, its
    collectives timed), the result gathered to rank 0 and held to the
    one-process step; a second mesh step timed (not bert4rec's, whose
    exchange is seconds)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_cell
    from repro_torch.data.cells import batch_for_cell
    from repro_torch.dist.group_ops import recording
    from repro_torch.dist.placement import Placement
    from repro_torch.launch import dryrun, train
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.loop import batch_to_device
    from repro_torch.tree import flatten_with_path

    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    kw = dict(vocab_cap=RS_VOCAB_CAP) if arch == "dlrm-rm2" and not reduced else {}
    if arch in RS_BATCH and not reduced:
        kw["global_batch"] = RS_BATCH[arch]
    one = get_cell(arch, shape, reduced=reduced, device=dev, **kw)
    bundle = get_cell(arch, shape, reduced=reduced, device=dev, mesh=mesh, **kw)
    pl = Placement(bundle, mesh)
    rank = dist.get_rank()
    batch = batch_for_cell(one, 0)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    full = one.make_state(11)
    state = pl.local_state(full)
    out = dict(split_mb=pl.split_bytes(state) / 1e6,
               batch=next(iter(one.make_inputs().values())).shape[0])
    want = None
    if rank == 0:
        sync()
        t0 = time.monotonic()
        s1, m1 = one.step_fn(full, batch_to_device(batch, dev))
        sync()
        out.update(one_process_ms=(time.monotonic() - t0) * 1e3, one_loss=float(m1["loss"]))
        want = _table_leaves(s1)
        del s1
    del full
    if cuda:
        torch.cuda.empty_cache()
    local = batch_to_device(pl.local_batch(batch), dev)
    dist.barrier()
    spent, unwrap = _timed_collectives()
    try:
        sync()
        t0 = time.monotonic()
        with recording() as rec:
            state, metrics = bundle.step_fn(state, local)
        sync()
        out["mesh_ms"] = (time.monotonic() - t0) * 1e3
    finally:
        unwrap()
    out.update(exchange_ms=spent[0] * 1e3, loss=float(metrics["loss"]),
               replicated=train.params_digest(
                   [leaf for path, leaf in flatten_with_path(state.params)
                    if pl.param_is_replicated(path)]))
    got = rec.summary()
    count, _ = dryrun.count_collectives(arch, shape, Mesh(dict(mesh.shape)), reduced=reduced,
                                        global_batch=kw.get("global_batch"))
    out.update(bytes=got["total"], wire_bytes=got["wire_total"], counts=got["counts"],
               count_equal=got == count)
    whole = pl.gather_state(state)
    if rank == 0:
        have = _table_leaves(whole)
        check(sorted(have) == sorted(want), f"{arch}: the gathered leaves {sorted(have)}")
        errs, worst_abs, touched_equal = {}, 0.0, True
        for k, w in want.items():
            if k.startswith("touched"):
                touched_equal &= bool(torch.equal(have[k], w))
            else:
                diff = (have[k] - w).abs()
                errs[k] = float((diff - RS_RTOL * w.abs()).max())
                worst_abs = max(worst_abs, float(diff.max()))
        worst = max(errs, key=errs.get)
        out.update(loss_err=abs(out["loss"] - out["one_loss"]), touched_equal=touched_equal,
                   worst_leaf=worst, worst_excess=errs[worst], worst_abs=worst_abs)
    del whole
    if arch != "bert4rec":
        dist.barrier()
        sync()
        t0 = time.monotonic()
        state, _ = bundle.step_fn(state, local)
        sync()
        out["second_mesh_ms"] = (time.monotonic() - t0) * 1e3
    if cuda:
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del state, local
    if cuda:
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def recsys_worker(mesh, root, device, reduced) -> dict:
    """One rank's row-sharded recsys cells (phase 17): dlrm-rm2 (vocabularies
    capped at 2^20), xdeepfm, mind and bert4rec at full width,
    ``train_batch`` (65,536), and dimenet's ``molecule`` (128 x 30 atoms),
    each through ``_recsys_cell``; then dlrm-rm2 through ``launch.train.main
    --mesh 2x2`` in this process's group: 4 steps, 4-bit saves every 2 (the
    row-sharded state gathered to rank 0, which saves through
    ``quant_pack`` and ``chunk_hash``), a failure at 3, the rerun resuming
    from the one chain with every rank's range-read rows held to rank 0's
    whole restore."""
    import io
    from contextlib import redirect_stdout

    import torch
    import torch.distributed as dist

    from repro_torch.launch import train

    counters = _kernel_counters()
    for c in counters.values():
        c.reset()
    rank = dist.get_rank()
    dev = device if device == "cpu" else f"cuda:{rank % torch.cuda.device_count()}"
    if device == "cuda":
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)  # the allocator's statistics exist from here
    out = {}
    for arch, shape in RS_CELLS:
        t0 = time.monotonic()
        out[arch] = _recsys_cell(arch, shape, mesh, device, dev, reduced)
        out[arch]["seconds"] = time.monotonic() - t0
        print(f"rank {rank}: {arch} {json.dumps(out[arch])}", file=sys.stderr, flush=True)
    cmd = ["--arch", "dlrm-rm2", "--shape", "train_batch", "--mesh", "2x2", "--steps", "4",
           "--interval", "2", "--bits", "4", "--device", device,
           "--ckpt-dir", os.path.join(root, "dlrm-mesh-ckpt")]
    if not reduced:
        cmd += ["--full-config", "--vocab-cap", str(RS_VOCAB_CAP)]
    rcs, logs = [], []
    t0 = time.monotonic()
    for extra in (["--fail-at", "3"], []):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rcs.append(train.main(cmd + extra))
        logs.append(buf.getvalue())
    out["launcher"] = dict(rcs=rcs, seconds=time.monotonic() - t0,
                           log=logs if rank == 0 else None,
                           launches={k: c.count for k, c in counters.items()})
    return out


def _check_recsys_ranks(ranks, kernels=None):
    """Phase 17's checks of the ranks' row-sharded records, and its log
    line; rank 0's launches of the saves' kernels go into the kernel
    table."""
    r0 = ranks[0]
    for arch, _ in RS_CELLS:
        c = r0[arch]
        check(c["loss_err"] < RS_LOSS_BAR, f"{arch}: mesh loss {c['loss']} vs one process's "
              f"{c['one_loss']}")
        check(c["worst_excess"] <= RS_ATOL, f"{arch}: tables and accumulators within rtol "
              f"{RS_RTOL}, atol {RS_ATOL} of one process's step ({c['worst_leaf']} "
              f"exceeds rtol by {c['worst_excess']:.3e})")
        check(c["touched_equal"], f"{arch}: touched masks equal to one process's")
        for r, rec in enumerate(ranks):
            check(rec[arch]["count_equal"], f"{arch} rank {r}: one step's collectives equal "
                  f"the dry run's count on 2 x 2: {rec[arch]['counts']}")
            check(rec[arch]["replicated"] == c["replicated"] and rec[arch]["bytes"] == c["bytes"],
                  f"{arch} rank {r}: replicated parameters and bytes as rank 0's")
    for r, rec in enumerate(ranks):
        la = rec["launcher"]
        check(la["rcs"] == [2, 0], f"rank {r}: dlrm-rm2 --mesh fail then resume {la['rcs']}")
        saves = {k: la["launches"][k] for k in ("quant_pack", "chunk_hash")}
        others = {k: v for k, v in la["launches"].items() if k not in saves}
        check(not any(others.values()), f"rank {r}: launches of other kernels: {others}")
        check(all(saves.values()) if r == 0 else not any(saves.values()),
              f"rank {r}: launches of the saves' kernels on rank 0 alone: {saves}")
    first, second = r0["launcher"]["log"]
    check("resumed from checkpoint at step 2" in second
          and "restored rows of 4 ranks bit-equal to the one-process restore" in second
          and "parameters bit-equal after every step and the restore" in second,
          f"the rerun resumed from the one chain: {second[-800:]}")
    gather = [line for line in second.splitlines() if "to rank 0 a save" in line]
    if kernels is not None:
        record_launches(kernels, "mesh dlrm-rm2 saves",
                        {k: r0["launcher"]["launches"][k] for k in ("quant_pack", "chunk_hash")})
    cells = {}
    for arch, _ in RS_CELLS:
        c = r0[arch]
        cells[arch] = dict(
            mesh_step_ms_by_rank=[round(rec[arch]["mesh_ms"], 1) for rec in ranks],
            second_step_ms_by_rank=[round(rec[arch].get("second_mesh_ms", 0.0), 1)
                                    for rec in ranks] if arch != "bert4rec" else None,
            one_process_ms=round(c["one_process_ms"], 1),
            exchange_share=[round(rec[arch]["exchange_ms"] / rec[arch]["mesh_ms"], 3)
                            for rec in ranks],
            bytes_a_rank=c["bytes"], wire_bytes_a_rank=c["wire_bytes"], counts=c["counts"],
            batch=c["batch"], loss=[c["loss"], c["one_loss"]], worst_leaf=c["worst_leaf"],
            worst_abs=c["worst_abs"],
            worst_excess=c["worst_excess"], split_mb_a_rank=round(c["split_mb"], 2),
            peak_gb_by_rank=[round(rec[arch].get("peak_gb", 0.0), 2) for rec in ranks],
            seconds=round(c["seconds"], 1))
    out = dict(card=card_name(), cells=cells, launcher_s=[round(rec["launcher"]["seconds"], 1)
                                                          for rec in ranks],
               gather=gather, launches=r0["launcher"]["launches"])
    log(f"row-sharded recsys: {json.dumps(out)}")
    return out


# The LM train cells on a mesh (phase 17): the five train_4k
# cells at full width (d, heads, ff, experts, vocabulary as published) and
# sequence 4,096, depth and batch cut so that the phase fits the smoke's
# time and four ranks' state the one card, each on the mesh that shards
# what it must (PERF.md §4). One mesh step is held to one process's loss
# and gradients of the same parameters and batch, taken in rank 0's
# process once the ranks have freed the card: the loss within LM_LOSS_BAR,
# every leaf's |gradient| (the square root of its first accumulator;
# tok_emb's row-wise one gives each row's RMS) within LM_GRAD_BAR of the
# leaf's largest (the sharded DimeNet's bf16 bar), the touched masks
# equal; all in bf16. The MoE cells' held step drops nothing (capacity E /
# top_k) and has no aux loss, and the one process routes each token as the
# mesh did: routing is discontinuous, and without that (an H100 80GB HBM3
# at 700 W, PERF.md §6) the mesh's rounding moved 403 of olmoe's 16,384
# first-layer tokens (bf16, 2 layers, batch 4) past a near-tie, which put
# w_out's gradient 0.28 of its largest away from one process routing on
# its own; in f32 dbrx's layer (batch 1) still moved 1 of 4,096, which put
# w_out's 0.32 away. Forcing can only absorb near-ties, not a wrong
# router: in the first MoE layer, whose router's input differs only by
# rounding, no routing probability may move by more than
# LM_ROUTE_MOVE_BAR, and every token the mesh routes otherwise than one
# process would must be a near-tie that rounding moved past (``_flips``);
# in every layer at most LM_FLIP_SHARE_BAR of the tokens may route
# otherwise. LM_FORCE_ROUTING = False (``tools/lm_mesh.py --unforced``)
# holds the step to one process routing on its own. The launcher runs keep
# the configs as they are.
LM_CELLS = (("qwen2-0.5b", (2, 2), 2, 2), ("nemotron-4-15b", (1, 4), 2, 1),
            ("olmoe-1b-7b", (2, 2), 1, 2), ("dbrx-132b", (1, 4), 1, 1),
            ("minicpm3-4b", (2, 2), 1, 2))   # (arch, (data, model), layers, global batch)
# the launcher runs, (arch, layers, batch): olmoe's 2 layers took 162 s with
# their saves' 7.9 GB gathers (PERF.md §6); 1 keeps the phase in
# the smoke's time (the CPU test restores 2 layers' experts, one range a
# layer)
LM_LAUNCHED = (("qwen2-0.5b", 2, 2), ("olmoe-1b-7b", 1, 2))
LM_LOSS_BAR = 1e-2
LM_GRAD_BAR = 0.05
LM_ROUTE_MOVE_BAR = 2 ** -8   # a routing probability's move in the first MoE layer
LM_FLIP_SHARE_BAR = 0.05      # of a layer's tokens routed otherwise than one process
LM_FORCE_ROUTING = True
LM_SEED = 13


def _lm_held_config(arch, layers, reduced):
    """A held step's config: ``layers`` deep (2 at most when ``reduced``);
    MoE with no aux loss and nothing dropped."""
    from repro_torch.configs import _module

    cfg = _module(arch).make_config(reduced)
    cfg = dataclasses.replace(cfg, n_layers=min(layers, cfg.n_layers))
    if cfg.moe:
        cfg = dataclasses.replace(cfg, aux_loss_coef=0.0, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg


def _routing(layers, forced=None):
    """Wrap the MoE router so each call notes, on the host, each token's
    experts (sorted), its gap between the k-th and (k+1)-th routing
    probability and (layer 0) its probabilities; with ``forced`` (a layer's
    experts for each token, sorted) route as those say, the weights the
    router's probabilities of them renormalized. A step's router calls are
    its L layers' forward, then their recomputation in the backward, last
    layer first. → (the notes of the forward's calls, unwrap)."""
    import torch

    from repro_torch.models import layers as m_layers

    seen, router = [], m_layers._moe_router

    def noted(xf, w, top_k):
        probs, weights, ids = router(xf, w, top_k)
        c = len(seen)
        if c < layers:
            top = torch.topk(probs.detach(), top_k + 1, dim=-1).values
            seen.append((ids.detach().sort(dim=-1).values.to("cpu", torch.int16),
                         (top[:, top_k - 1] - top[:, top_k]).to("cpu"),
                         probs.detach().to("cpu") if c == 0 else None))
        else:
            seen.append(None)
        if forced is not None:
            ids = forced[c if c < layers else 2 * layers - 1 - c].to(probs.device, torch.int64)
            weights = torch.gather(probs, 1, ids)
            weights = weights / torch.sum(weights, dim=-1, keepdim=True)
        return probs, weights, ids

    m_layers._moe_router = noted
    return seen, lambda: setattr(m_layers, "_moe_router", router)


def _flips(one, mesh_routes, layers):
    """Per layer, the share of the global batch's tokens the mesh routed to
    other experts than one process would have (its own router's choice);
    of layer 0, the largest change of a routing probability between the
    two, and the largest ratio of a token routed otherwise's gap between
    its k-th and (k+1)-th probability (one process's) to twice the largest
    change of its probabilities: there the router's input differs only by
    rounding, so a token routes otherwise only where that rounding moved
    two probabilities past each other (a ratio of at most 1); later layers
    inherit its changed state. → (counts, shares, move, ratio)."""
    counts, shares, worst = [], [], 0.0
    moved = (one[0][2] - mesh_routes[0][2]).abs().amax(dim=-1)
    for l in range(layers):
        diff = (one[l][0] != mesh_routes[l][0]).any(dim=-1)
        counts.append(int(diff.sum()))
        shares.append(counts[-1] / diff.numel())
        if l == 0 and diff.any():
            worst = float((one[0][1] / (2 * moved))[diff].max())
    return counts, shares, float(moved.max()), worst


def _mesh_routes(routes, mesh, layers):
    """The global batch's routing on the mesh, on rank 0: each data
    shard's (its ``model`` rank 0's record) in data order; None elsewhere."""
    import numpy as np
    import torch
    import torch.distributed as dist

    every = [None] * mesh.size
    dist.all_gather_object(every, [(ids.numpy(), gaps.numpy(),
                                    None if probs is None else probs.numpy())
                                   for ids, gaps, probs in routes[:layers]], group=mesh.group)
    if dist.get_rank(mesh.group) != 0:
        return None
    shards = [rec for r, rec in enumerate(every)
              if not dict(zip(mesh.shape, np.unravel_index(
                  r, tuple(mesh.shape.values())))).get("model", 0)]
    return [tuple(None if shards[0][l][m] is None
                  else torch.from_numpy(np.concatenate([sh[l][m] for sh in shards]))
                  for m in range(3)) for l in range(layers)]


def _lm_one_process(one, cfg, dev, folder, sync, forced=None):
    """One process's loss and gradients of the whole parameters (the step
    before its update, whose accumulators would hold three more copies:
    nemotron's and dbrx's do not fit the card so) on ``one``'s batch 0,
    each MoE layer routed as ``forced`` says where given: each leaf's
    |gradient| (a table's row RMS, as its row-wise accumulator gives) and
    each touched mask written to ``folder`` as ``.npy`` (bf16 bits as
    int16). → (ms, loss, its own routing's notes)."""
    import numpy as np
    import torch

    from repro_torch.data.cells import batch_for_cell
    from repro_torch.models import transformer as m_tf
    from repro_torch.train.loop import batch_to_device
    from repro_torch.tree import flatten_with_path, keystr

    gen = torch.Generator(device=one.device)
    gen.manual_seed(LM_SEED)
    params = one.init(gen)
    paths = [p for p, _ in flatten_with_path(params)]
    leaves = [leaf.requires_grad_(True) for _, leaf in flatten_with_path(params)]
    batch = batch_to_device(batch_for_cell(one, 0), dev)
    routes, unwrap = _routing(cfg.n_layers, forced)
    try:
        sync()
        t0 = time.monotonic()
        loss, aux = m_tf.train_loss(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        sync()
    finally:
        unwrap()
    ms = (time.monotonic() - t0) * 1e3
    del params, leaves, batch
    with torch.no_grad():
        for p, g in zip(paths, grads):
            g = g.square().mean(dim=1).sqrt() if p[0] == "tables" else g.abs()
            np.save(os.path.join(folder, "grad" + keystr(p) + ".npy"),
                    g.to(torch.bfloat16).view(torch.int16).cpu().numpy())
        for name, m in aux["touched"].items():
            np.save(os.path.join(folder, f"touched{name}.npy"), m.cpu().numpy())
    return ms, float(loss), routes[:cfg.n_layers]


def _lm_held_blocks(grads, touched, pl, folder):
    """This rank's blocks (|gradient| as bf16 and touched masks, on the
    host) against one process's, read from ``folder`` (each file
    memory-mapped, the rank's block sliced): per leaf, the largest
    |Δ|gradient|| and the largest one-process |gradient| of the block; per
    touched mask, whether the block is equal."""
    import numpy as np
    import torch

    from repro_torch.dist.placement import shard_bounds
    from repro_torch.tree import flatten_with_path, keystr

    specs = {keystr(p): s for p, s in flatten_with_path(pl.specs.opt_state)}
    out = {}
    for key, got in grads.items():
        want = np.load(os.path.join(folder, "grad" + key + ".npy"), mmap_mode="r")
        block = tuple(slice(lo, hi) for lo, hi in shard_bounds(want.shape, specs[key], pl.mesh))
        want = torch.from_numpy(np.ascontiguousarray(want[block])).view(torch.bfloat16)
        want = want.to(torch.float32)
        out[key] = (float((got.to(torch.float32) - want).abs().max()), float(want.max()))
    same = {}
    for name, mask in touched.items():
        want = np.load(os.path.join(folder, f"touched{name}.npy"), mmap_mode="r")
        block = tuple(slice(lo, hi) for lo, hi in
                      shard_bounds(want.shape, pl.specs.touched[name], pl.mesh))
        same[name] = bool(np.array_equal(mask, want[block]))
    return out, same


def _lm_cell(arch, mesh, layers, gb, root, device, dev, reduced) -> dict:
    """One cell of ``lm_worker``: every rank makes its blocks leaf by leaf
    (``Placement.init_state``: one whole leaf transient at a time) and
    steps them on the mesh (recorded, its collectives timed; the update in
    place), keeps its |gradient| blocks and masks on its host and frees the
    card; rank 0 then takes one process's loss and gradients of the same
    parameters and batch (``_lm_one_process``, an MoE routed as the mesh
    routed); each rank holds its blocks to those (``_lm_held_blocks``) and
    rank 0 gathers the verdicts."""
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.configs._families import lm_cell
    from repro_torch.data.cells import batch_for_cell
    from repro_torch.dist.group_ops import recording
    from repro_torch.dist.placement import Placement
    from repro_torch.launch import dryrun, train
    from repro_torch.launch.mesh import Mesh, make_recording_mesh
    from repro_torch.train.loop import batch_to_device
    from repro_torch.tree import flatten_with_path, keystr

    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = _lm_held_config(arch, layers, reduced)
    gb = 4 if reduced else gb
    rank, L = dist.get_rank(), cfg.n_layers
    folder = os.path.join(root, f"lm-held-{arch}")
    out = dict(layers=L, batch=gb, mesh=list(mesh.shape.values()))
    b = lm_cell(arch, cfg, "train_4k", reduced, dev, gb, mesh=mesh)
    pl = Placement(b, mesh)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    state = pl.init_state(LM_SEED)
    if cuda:
        torch.cuda.empty_cache()
    local = batch_to_device(pl.local_batch(batch_for_cell(b, 0)), dev)
    routes, unwrap = _routing(L)
    dist.barrier()
    spent, unwrap_timed = _timed_collectives()
    try:
        sync()
        t0 = time.monotonic()
        with recording() as rec:
            state, metrics = b.step_fn(state, local)
        sync()
        out["mesh_ms"] = (time.monotonic() - t0) * 1e3
    finally:
        unwrap_timed()
        unwrap()
    out.update(collectives_ms=spent[0] * 1e3, loss=float(metrics["loss"]),
               replicated=train.params_digest(
                   [leaf for path, leaf in flatten_with_path(state.params)
                    if pl.param_is_replicated(path)]))
    if cuda:
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    got = rec.summary()
    meta = lm_cell(arch, cfg, "train_4k", reduced, "meta", gb,
                   mesh=make_recording_mesh(Mesh(dict(mesh.shape))))
    count = dryrun.lm_step_collectives(meta, meta.rules.mesh, reduced, gb)
    out.update(bytes=got["total"], wire_bytes=got["wire_total"], counts=got["counts"],
               count_equal=(got["counts"] == count["counts"] and got["total"] == count["total"]
                            and abs(got["wire_total"] - count["wire_total"])
                            <= 1e-9 * count["wire_total"]))
    with torch.no_grad():
        grads = {keystr(p): acc.sqrt().to(torch.bfloat16).cpu()
                 for p, acc in flatten_with_path(state.opt_state)}
    touched = {k: m.cpu().numpy() for k, m in state.touched.items()}
    del state, local, metrics
    if cuda:
        torch.cuda.empty_cache()
    mesh_routes = _mesh_routes(routes, mesh, L) if cfg.moe else None
    dist.barrier()
    if rank == 0:
        os.makedirs(folder, exist_ok=True)
        one = lm_cell(arch, cfg, "train_4k", reduced, dev, gb)
        forced = ([ids for ids, _, _ in mesh_routes] if cfg.moe and LM_FORCE_ROUTING
                  else None)
        out["one_process_ms"], out["one_loss"], own = _lm_one_process(
            one, cfg, dev, folder, sync, forced)
        if cfg.moe:
            out["flips"], out["flip_share"], out["route_move0"], out["flip_ratio0"] = _flips(
                own, mesh_routes, L)
            out["forced"] = LM_FORCE_ROUTING
            out["margin"] = min(float(g.min()) for _, g, _ in own)
        if cuda:
            torch.cuda.empty_cache()
    dist.barrier()
    held = [None] * mesh.size
    dist.all_gather_object(held, _lm_held_blocks(grads, touched, pl, folder), group=mesh.group)
    if rank == 0:
        worst = {k: max(g[k][0] for g, _ in held) / max(max(g[k][1] for g, _ in held), 1e-30)
                 for k in held[0][0]}
        leaf = max(worst, key=worst.get)
        out.update(loss_err=abs(out["loss"] - out["one_loss"]), worst_leaf=leaf,
                   worst_grad=worst[leaf],
                   touched_equal=all(all(t.values()) for _, t in held))
    dist.barrier()
    if rank == 0:
        shutil.rmtree(folder, ignore_errors=True)
    return out


def lm_worker(root, device, reduced) -> dict:
    """One rank's LM train cells (phase 17): each of ``LM_CELLS`` through
    ``_lm_cell`` on its mesh (2 x 2 or 1 x 4 over this process's group);
    then ``launch.train.main --mesh 2x2`` for each of ``LM_LAUNCHED`` (its
    depth and batch cut), 3 steps, a 4-bit save at 2 gathered to rank 0
    (which saves through ``quant_pack`` and ``chunk_hash``), a failure
    before step 3, the rerun resuming from the one chain with every rank's
    range-read rows (``tok_emb``'s and the expert blocks') held to rank
    0's whole restore and training step 3 (one save: the smoke took
    1,121.7 s with two)."""
    import io
    from contextlib import redirect_stdout

    import torch
    import torch.distributed as dist

    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh

    rank = dist.get_rank()
    dev = device if device == "cpu" else f"cuda:{rank % torch.cuda.device_count()}"
    if device == "cuda":
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)  # the allocator's statistics exist from here
    meshes = {(2, 2): make_host_mesh(2, 2), (1, 4): make_host_mesh(1, 4)}
    out = {}
    for arch, shape, layers, gb in LM_CELLS:
        t0 = time.monotonic()
        out[arch] = _lm_cell(arch, meshes[shape], layers, gb, root, device, dev, reduced)
        out[arch]["seconds"] = time.monotonic() - t0
        print(f"rank {rank}: lm {arch} {json.dumps(out[arch])}", file=sys.stderr, flush=True)
    counters = _kernel_counters()
    out["launcher"] = {}
    for arch, layers, gb in LM_LAUNCHED:
        for c in counters.values():
            c.reset()
        cmd = ["--arch", arch, "--shape", "train_4k", "--mesh", "2x2", "--steps", "3",
               "--interval", "2", "--bits", "4", "--device", device,
               "--ckpt-dir", os.path.join(root, f"{arch}-mesh-ckpt")]
        if not reduced:
            cmd += ["--full-config", "--layers", str(layers), "--global-batch", str(gb)]
        rcs, logs = [], []
        t0 = time.monotonic()
        for extra in (["--fail-at", "2"], []):
            buf = io.StringIO()
            with redirect_stdout(buf):
                rcs.append(train.main(cmd + extra))
            logs.append(buf.getvalue())
        out["launcher"][arch] = dict(rcs=rcs, seconds=time.monotonic() - t0,
                                     log=logs if rank == 0 else None,
                                     launches={k: c.count for k, c in counters.items()})
        print(f"rank {rank}: lm launcher {arch} {rcs} {time.monotonic() - t0:.1f} s",
              file=sys.stderr, flush=True)
    return out


def _check_lm_ranks(ranks, kernels=None):
    """Phase 17's checks of the ranks' LM records, and its log line; rank
    0's launches of the saves' kernels go into the kernel table."""
    r0 = ranks[0]
    cells = {}
    for arch, shape, *_ in LM_CELLS:
        c = r0[arch]
        check(c["loss_err"] <= LM_LOSS_BAR, f"lm {arch}: mesh loss {c['loss']} vs one "
              f"process's {c['one_loss']}")
        check(c["worst_grad"] <= LM_GRAD_BAR, f"lm {arch}: |gradient| within {LM_GRAD_BAR} "
              f"of each leaf's largest ({c['worst_leaf']}: {c['worst_grad']:.3e})")
        check(c["touched_equal"], f"lm {arch}: touched masks equal to one process's")
        for r, rec in enumerate(ranks):
            check(rec[arch]["count_equal"], f"lm {arch} rank {r}: one step's collectives "
                  f"equal the dry run's count on {shape}: {rec[arch]['counts']}")
            check(rec[arch]["replicated"] == c["replicated"] and rec[arch]["bytes"] == c["bytes"],
                  f"lm {arch} rank {r}: replicated parameters and bytes as rank 0's")
        if "flips" in c:
            check(c["forced"], f"lm {arch}: the one-process step routed as the mesh did")
            check(c["route_move0"] <= LM_ROUTE_MOVE_BAR, f"lm {arch}: the first layer's "
                  f"routing probabilities within {LM_ROUTE_MOVE_BAR} of one process's "
                  f"({c['route_move0']:.3e})")
            check(c["flip_ratio0"] <= 1.0, f"lm {arch}: each token of the first layer the "
                  f"mesh routed otherwise than one process would is a near-tie its rounding "
                  f"moved past (gap over twice the move {c['flip_ratio0']:.3f} <= 1; by "
                  f"layer {c['flips']})")
            check(max(c["flip_share"]) <= LM_FLIP_SHARE_BAR, f"lm {arch}: at most "
                  f"{LM_FLIP_SHARE_BAR} of each layer's tokens routed otherwise than one "
                  f"process would ({c['flip_share']})")
        cells[arch] = dict(
            mesh="x".join(str(n) for n in c["mesh"]), layers=c["layers"], batch=c["batch"],
            mesh_step_ms_by_rank=[round(rec[arch]["mesh_ms"], 1) for rec in ranks],
            one_process_ms=round(c["one_process_ms"], 1),
            collectives_share=[round(rec[arch]["collectives_ms"] / rec[arch]["mesh_ms"], 3)
                               for rec in ranks],
            bytes_a_rank=c["bytes"], wire_bytes_a_rank=c["wire_bytes"], counts=c["counts"],
            loss=[c["loss"], c["one_loss"]], worst_leaf=c["worst_leaf"],
            routing_margin=c.get("margin"), flips=c.get("flips"),
            flip_share=c.get("flip_share"), route_move0=c.get("route_move0"),
            flip_ratio0=c.get("flip_ratio0"),
            worst_grad=c["worst_grad"],
            peak_gb_by_rank=[round(rec[arch].get("peak_gb", 0.0), 2) for rec in ranks],
            seconds=round(c["seconds"], 1))
    launched = {}
    for arch, _, _ in LM_LAUNCHED:
        for r, rec in enumerate(ranks):
            la = rec["launcher"][arch]
            check(la["rcs"] == [2, 0], f"rank {r}: {arch} --mesh fail then resume {la['rcs']}")
            saves = {k: la["launches"][k] for k in ("quant_pack", "chunk_hash")}
            others = {k: v for k, v in la["launches"].items() if k not in saves}
            check(not any(others.values()), f"rank {r}: {arch}: launches of other kernels: "
                  f"{others}")
            check(all(saves.values()) if r == 0 else not any(saves.values()),
                  f"rank {r}: {arch}: launches of the saves' kernels on rank 0 alone: {saves}")
        second = r0["launcher"][arch]["log"][1]
        check("resumed from checkpoint at step 2" in second
              and "restored rows of 4 ranks bit-equal to the one-process restore" in second
              and "parameters bit-equal after every step and the restore" in second,
              f"{arch}: the rerun resumed from the one chain: {second[-800:]}")
        if kernels is not None:
            record_launches(kernels, f"mesh {arch} saves",
                            {k: r0["launcher"][arch]["launches"][k]
                             for k in ("quant_pack", "chunk_hash")})
        launched[arch] = dict(
            seconds=[round(rec["launcher"][arch]["seconds"], 1) for rec in ranks],
            launches=r0["launcher"][arch]["launches"])
    out = dict(card=card_name(), cells=cells, launcher=launched)
    log(f"lm mesh: {json.dumps(out)}")
    return out


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
    phase_s, last = {}, [t0]

    def mark(name):
        """Log the seconds since the previous mark as phase ``name``'s."""
        now = time.monotonic()
        phase_s[name] = round(now - last[0], 1)
        last[0] = now

    def in_tempdir(tag, fn, *args):
        root = tempfile.mkdtemp(prefix=f"cnr-chip-smoke-{tag}-")
        try:
            return fn(*args, root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
            mark(tag)

    card, sass = phase_device()
    try:
        kernels = phase_kernels()
    finally:
        finish_sass_check(sass)
    mark("device and kernels")
    if not args.kernels_only:
        root = tempfile.mkdtemp(prefix="cnr-chip-smoke-")
        trainer = None
        single_host = {}
        try:
            trainer = phase_main_path(kernels, root, single_host)
            _, params = phase_serve(kernels, root, trainer)
            phase_retrieval(kernels, params)
            del params
        finally:
            if trainer is not None:
                trainer.close()
            shutil.rmtree(root, ignore_errors=True)
            mark("dlrm-rm2")
        # the host-process phase's object server imports torch (10-20 s of
        # the host) while the sharded phase runs
        mp_root = tempfile.mkdtemp(prefix="cnr-chip-smoke-mp-")
        server = start_object_server(os.path.join(mp_root, "server"))
        try:
            in_tempdir("sharded", lambda root: phase_sharded(kernels, root, single_host))
            phase_multiprocess(kernels, mp_root, server=server)
        finally:
            server.kill()
            server.wait()
            shutil.rmtree(mp_root, ignore_errors=True)
            mark("mp")
        in_tempdir("b4r", phase_bert4rec, kernels)
        in_tempdir("xdeepfm", phase_xdeepfm, kernels)
        trained, _ = in_tempdir("mind", phase_mind, kernels)
        phase_kmeans(kernels, trained)
        del trained
        mark("k-means")
        phase_recovery_experiment()
        mark("recovery experiment")
        dimenet_out = in_tempdir("dimenet", phase_dimenet, kernels)
        in_tempdir("qwen2", phase_qwen2, kernels)
        in_tempdir("nemotron", phase_nemotron, kernels)
        in_tempdir("olmoe", phase_olmoe, kernels)
        in_tempdir("minicpm3", phase_minicpm3, kernels)
        in_tempdir("dbrx", phase_dbrx, kernels)
        in_tempdir("dryrun", phase_dryrun)
        in_tempdir("mesh", lambda root: phase_moe_ep(
            root, one_process_step_s=dimenet_out["minibatch_lg"]["step_s"], kernels=kernels))
        for k in kernels:
            check(k["launches"] > 0, f"{k['name']} ran on its path")
    log(f"seconds by phase: {json.dumps(phase_s)}")
    log(f"total {time.monotonic() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
