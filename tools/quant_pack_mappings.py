#!/usr/bin/env python3
"""Compare lane mappings of the ``quant_pack`` kernel on one CUDA card.

    python3 tools/quant_pack_mappings.py

Builds copies of ``src/repro_torch/kernels/csrc/quant_pack.cu`` into
``build/quant_pack_mappings/`` with 8, 16 and 32 values a lane (the
committed kernel has 16), and one with 16 whose codes always go through
the shared-memory pack; checks each against the plain version (uniform
words identical, adaptive within the quantizers' bars) and against the
committed mapping (bit for bit; the mappings differ in which lane holds
which value, not in the order of any sum); then times each at (65536, 64), 4-bit
adaptive and 8-bit uniform, in two rounds in turn (a, b, c, d, d, c, b,
a). Prints one JSON line.

The times of the mappings left out in PERF.md come from this script. Run
it again before changing the kernel's lane mapping: it raises if the
source no longer has the two lines it rewrites.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "quant_pack_mappings")
SMEM_ONLY = ("const bool reg_pack = FULL && packs_in_registers<L, K>(a.bits);",
             "const bool reg_pack = false;")


def variants() -> dict:
    """name -> source text, the committed mapping first."""
    src = open(os.path.join(CSRC, "quant_pack.cu")).read()
    out = {}
    for v in (16, 8, 32):
        text, n = re.subn(r"constexpr int kValuesPerLane = \d+;",
                          f"constexpr int kValuesPerLane = {v};", src)
        if n != 1:
            raise RuntimeError("quant_pack.cu no longer declares kValuesPerLane once; "
                               "update this script's variants")
        out[f"{v} values a lane"] = text
    if src.count(SMEM_ONLY[0]) != 1:
        raise RuntimeError("quant_pack.cu no longer chooses reg_pack in one line; "
                           "update this script's variants")
    out["16 values a lane, shared-memory pack"] = src.replace(*SMEM_ONLY)
    return out


def build(sources: dict) -> dict:
    """Every variant by its own nvcc process, all started together, with
    the build's flags for this file. -> name -> loaded library."""
    from repro_torch.kernels import build as kb

    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu, so = os.path.join(OUT, f"v{i}.cu"), os.path.join(OUT, f"v{i}.so")
        open(cu, "w").write(text)
        cmd = ([kb._nvcc()] + kb.ARCH_FLAGS + kb.COMMON_FLAGS
               + kb.EXTRA_FLAGS["quant_pack.cu"] + ["-I", CSRC, "-shared", cu, "-o", so])
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, p) in procs.items():
        text = p.communicate()[0].decode(errors="replace")
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        lib = ctypes.CDLL(so)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.quant_pack_launch.argtypes = [vp, vp, vp, vp] + [i32] * 5 + [i64, vp]
        lib.quant_pack_launch.restype = i32
        libs[name] = lib
    return libs


def launch(lib, x, bits, num_bins, n_steps):
    import torch

    rows, dim = x.shape
    nwords = (rows * dim * bits + 31) // 32
    words = torch.empty(nwords, dtype=torch.uint32, device=x.device)
    scale = torch.empty(rows, device=x.device)
    zero = torch.empty(rows, device=x.device)
    err = lib.quant_pack_launch(x.data_ptr(), words.data_ptr(), scale.data_ptr(),
                                zero.data_ptr(), rows, dim, bits, num_bins, n_steps,
                                nwords, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"quant_pack_launch: cudaError_t {err}")
    return words, scale, zero


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.adaptive_quant import ops

    if not torch.cuda.is_available():
        print("quant_pack_mappings: torch sees no CUDA device", file=sys.stderr)
        return 1
    libs = build(variants())
    committed = next(iter(libs))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    failures = []
    n_checks = 0
    for rows, dim in ((65536, 64), (1000, 10), (333, 200), (500, 16), (300, 96),
                      (257, 128), (70, 1024), (40, 32)):
        x = cs._rows(gen, rows, dim, "cuda")
        for bits in range(1, 9):
            for method in ("uniform_asym", "adaptive") if bits in (2, 3, 4) else ("uniform_asym",):
                nb, ns = ops._resolve_steps(method, bits, None, None)
                p = ops.quant_pack_torch(x, bits=bits, num_bins=nb, n_steps=ns)
                want = launch(libs[committed], x, bits, nb, ns)
                for name, lib in libs.items():
                    got = launch(lib, x, bits, nb, ns)
                    n_checks += 1
                    same = all(torch.equal(a, b) for a, b in zip(got, want))
                    if method == "uniform_asym":
                        plain = all(torch.equal(a, b) for a, b in
                                    zip(got, (p.words, p.scale, p.zero)))
                    else:  # the quantizers' bars
                        k = cs._codes(ops.PackedQuant(got[0], got[1], got[2], bits,
                                                      rows * dim))
                        plain = (torch.allclose(got[1], p.scale, rtol=1e-5, atol=1e-7)
                                 and torch.allclose(got[2], p.zero, rtol=1e-5, atol=1e-7)
                                 and (k != cs._codes(p)).mean() <= 2e-3)
                    if not (same and plain):
                        failures.append(dict(variant=name, shape=[rows, dim], bits=bits,
                                             method=method, same_as_committed=same,
                                             equal_to_plain=plain))
    x = cs._rows(gen, 65536, 64, "cuda")
    nb, ns = ops._resolve_steps("adaptive", 4, None, None)
    times = {name: {"adaptive_4bit_ms": [], "uniform_8bit_ms": []} for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        lib = libs[name]
        times[name]["adaptive_4bit_ms"].append(
            cs.kernel_ms(lambda: launch(lib, x, 4, nb, ns), "quant_pack_kernel"))
        times[name]["uniform_8bit_ms"].append(
            cs.kernel_ms(lambda: launch(lib, x, 8, 1, 0), "quant_pack_kernel"))
    print(json.dumps(dict(card=torch.cuda.get_device_name(0), checks=n_checks,
                          failures=failures, times=times)))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
