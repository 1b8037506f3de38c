"""Published peaks of one NVIDIA H100 SXM (dense, without sparsity, at the
700 W power limit) and the least time a piece of work can take on it.

Frozen copy of ``chip_smoke.py``'s ``SMS``, ``CLOCK_HZ``,
``LANES_PER_CLOCK``, ``ISSUE_PER_CLOCK`` and ``bound`` (with the peaks of
``src/repro_torch/launch/mesh.py``), returning seconds. A kernel with no
FLOP peak that fits (quantization, hashing) is bound by its instruction
pipes' lane rates: the f32 clock is the one the 67 TFLOP/s f32 peak
implies (132 SMs x 128 lanes x 2 FLOP a fused multiply-add); "fma" = f32
add and multiply, 128 lanes a clock an SM; "alu" = f32 min/max and 32-bit
integer add, multiply, shift and xor, 64; "xu" = conversions and the
reciprocal of an IEEE divide, 16 (CUDA C++ Programming Guide, arithmetic
instruction throughput, compute capability 9.0); every instruction also
takes one of 128 issue slots a clock an SM.
"""

from __future__ import annotations

from typing import Dict

PEAK_BF16_FLOPS = 989e12      # dense bf16 on the tensor cores
PEAK_BYTES_S = 3.35e12        # HBM3
SMS = 132
CLOCK_HZ = 67e12 / (SMS * 128 * 2)
LANES_PER_CLOCK = {"fma": 128, "alu": 64, "xu": 16}
ISSUE_PER_CLOCK = 128


def bound_s(nbytes: float, instrs: Dict[str, float]) -> float:
    """The larger of ``nbytes`` over the memory rate and the instruction
    time of ``instrs`` (lane instructions by pipe): the busiest pipe, or
    issue if all pipes together take longer."""
    t_bytes = nbytes / PEAK_BYTES_S
    busy = [n / LANES_PER_CLOCK[c] for c, n in instrs.items()] or [0.0]
    clocks = max(max(busy), sum(instrs.values()) / ISSUE_PER_CLOCK)
    return max(t_bytes, clocks / (SMS * CLOCK_HZ))


def kernel_share(run, name: str, bound_of) -> float:
    """A kernel's share of its roofline in a traced run, in %: the least
    time of the work that the run's saves did (``bound_of(chunk)`` a
    chunk, from the chunk's shape alone) over the device time of every
    launch of the kernels whose name holds ``name``, however the work was
    split into launches. None where the trace holds none of them, or where
    the profiler lost a launch's device record (or could not tell)."""
    if run.trace is None or run.trace.get("lost_launches") != 0:
        return None
    times = [d for n, d in run.trace["kernels"] if name in n]
    chunks = [c for s in run.traced_saves for c in s["chunks"] if c[0] > 0 and c[2] is not None]
    if not times or not chunks:
        return None
    return 100.0 * sum(bound_of(c) for c in chunks) / (sum(times) / 1e9)
