#!/usr/bin/env python3
"""Hold the ``adaptive_quant`` kernel against an earlier version of itself
on one CUDA card, bit for bit, and time both in one process.

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/aq_parent
    python3 tools/adaptive_quant_parent.py --parent build/aq_parent/src/repro_torch/kernels/csrc

Builds ``adaptive_quant.cu`` of the directory given (with the headers beside
it) into ``build/adaptive_quant_parent/parent.so`` with the build's flags
for that file, and loads the checkout's own kernels as the port does. Both
quantize the same rows: random rows (``chip_smoke._rows``) and rows at
rounding ties (``kernels.adaptive_quant.ties.tie_rows``), at the smoke's
shapes and bit widths and at three search settings (num_bins 25 ratio 0.5,
45 and 0.2, and 25 and 1.5, whose ranges cross); codes, scale and zero must
be equal. Then times both at (1,000,448, 64), num_bins 25, ratio 0.5, at
2, 3, 4 and 8 bits, in turns (parent, change, change, parent), and counts
MUFU.RCP, FCHK and CALL in each version's kernels (``cuobjdump -sass``).
Prints one JSON line; exits 1 if any output differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

OUT = os.path.join(ROOT, "build", "adaptive_quant_parent")


def build_parent(src_dir: str) -> ctypes.CDLL:
    from repro_torch.kernels import build as kb

    os.makedirs(OUT, exist_ok=True)
    so = os.path.join(OUT, "parent.so")
    cmd = ([kb._nvcc()] + kb.ARCH_FLAGS + kb.COMMON_FLAGS
           + kb.EXTRA_FLAGS["adaptive_quant.cu"]
           + ["-I", src_dir, "-shared", os.path.join(src_dir, "adaptive_quant.cu"), "-o", so])
    p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if p.returncode != 0:
        raise RuntimeError("nvcc failed for the parent:\n" + p.stdout.decode(errors="replace"))
    lib = ctypes.CDLL(so)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.adaptive_quant_launch.argtypes = [vp, vp, vp, vp] + [i32] * 5 + [vp]
    lib.adaptive_quant_launch.restype = i32
    return lib


def launch(lib, x, bits, num_bins, ratio):
    import torch

    rows, dim = x.shape
    codes = torch.empty((rows, dim), dtype=torch.uint8, device=x.device)
    scale = torch.empty(rows, device=x.device)
    zero = torch.empty(rows, device=x.device)
    err = lib.adaptive_quant_launch(x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                                    zero.data_ptr(), rows, dim, bits, num_bins,
                                    int(ratio * num_bins),
                                    torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"adaptive_quant_launch: cudaError_t {err}")
    return codes, scale, zero


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build as kb
    from repro_torch.kernels.adaptive_quant.ties import tie_rows

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory holding the earlier adaptive_quant.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("adaptive_quant_parent: torch sees no CUDA device", file=sys.stderr)
        return 1
    libs = {"parent": build_parent(args.parent), "change": kb.library()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    failures, n_checks = [], 0
    for rows, dim in ((256, 64), (512, 10), (256, 128), (512, 200), (1, 1024),
                      (4099, 64), (cs.B4R_ITEMS, 64)):
        x = cs._rows(gen, rows, dim, "cuda")
        for bits in (2, 3, 4, 8):
            inputs = {"random": x}
            if rows <= 4099:
                inputs["ties"] = tie_rows(x, bits)
            for kind, xin in inputs.items():
                for nb, ratio in ((25, 0.5), (45, 0.2), (25, 1.5)):
                    a = launch(libs["parent"], xin, bits, nb, ratio)
                    b = launch(libs["change"], xin, bits, nb, ratio)
                    n_checks += 1
                    same = [bool(torch.equal(p, q)) for p, q in zip(a, b)]
                    if not all(same):
                        failures.append(dict(shape=[rows, dim], bits=bits, rows_kind=kind,
                                             num_bins=nb, ratio=ratio,
                                             codes_scale_zero_equal=same,
                                             codes_differing=int((a[0] != b[0]).sum())))
        del x
    x = cs._rows(gen, cs.B4R_ITEMS, 64, "cuda")
    times = {name: {b: [] for b in (2, 3, 4, 8)} for name in libs}
    for name in ("parent", "change", "change", "parent"):
        for bits in (2, 3, 4, 8):
            times[name][bits].append(cs.kernel_ms(
                lambda: launch(libs[name], x, bits, 25, 0.5), "adaptive_quant_kernel", reps=20))
    sass = {name: cs.sass_counts(lib._name, ("adaptive_quant", "exact_code"),
                                 ("MUFU.RCP", "FCHK", "CALL"))
            for name, lib in libs.items()}
    print(json.dumps(dict(card=torch.cuda.get_device_name(0), checks=n_checks,
                          failures=failures, times_ms=times, sass=sass)))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
