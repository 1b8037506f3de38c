"""``chunk_hash``'s share of its roofline over the saves the traced window
started: each chunk's least time from the count of its packed words alone,
over the profiler's device time of the kernels named ``chunk_hash``, in %.

The words (``ceil(ceil(n * dim * bits / 8) / 4)``) are read once and the
4-byte sum written once; each word costs 7 integer lane instructions (the
multiply-adds ``w + i * P2`` and ``sum + t * P3``, the multiply by P1, two
shifts, two xors), frozen from ``chip_smoke.py``'s count. No FLOP peak
fits: the instruction pipes' rates bound it, and at these sizes the bytes
do."""

from cnr_bench.roofline import bound_s, kernel_share


def chunk_bound_s(chunk):
    rows, dim, bits = chunk
    words = ((rows * dim * bits + 7) // 8 + 3) // 4
    return bound_s(words * 4 + 4, {"alu": 7 * words})


def read(run):
    return kernel_share(run, "chunk_hash", chunk_bound_s)
