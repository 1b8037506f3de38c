"""``quant_pack``'s share of its roofline over the saves the traced window
started: each chunk's least time from its shape alone, over the profiler's
device time of the kernels named ``quant_pack``, in %.

A chunk of ``n`` rows of ``dim`` values at ``bits`` bits, searched over
``2 * int(ratio * bins) + 1`` candidate ranges (the starting range and two
a step), reads its values once and writes its packed words, scale and zero
once. Its lane instructions are the frozen copy of ``chip_smoke.py::
_qp_instrs``: per value (the per-row work is left out) min, max; for each
candidate sub, mul, max, min, the rounding's two adds, sub, mul, add; for
the final code max, min, sub, a divide (one reciprocal, five fma-pipe
instructions, one range check), the rounding's two adds, max, min, a
conversion. No FLOP peak fits: the instruction pipes' rates bound it."""

from cnr_bench.roofline import bound_s, kernel_share


def _qp_instrs(n_el, n_cand):
    div = {"xu": 1, "fma": 5, "alu": 1}
    per = {"alu": 2 + 2 * n_cand + 4 + div["alu"],
           "fma": 7 * n_cand + 3 + div["fma"],
           "xu": 1 + div["xu"]}
    return {c: n_el * n for c, n in per.items()}


def chunk_bound_s(chunk, quant):
    rows, dim, bits = chunk
    n_el = rows * dim
    words = (n_el * bits + 31) // 32
    n_steps = int(quant["ratio"] * quant["num_bins"]) if quant["method"] == "adaptive" else 0
    return bound_s(n_el * 4 + words * 4 + 2 * rows * 4, _qp_instrs(n_el, 2 * n_steps + 1))


def read(run):
    return kernel_share(run, "quant_pack", lambda c: chunk_bound_s(c, run.traffic["quant"]))
