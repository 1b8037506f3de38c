#!/usr/bin/env python3
"""Time variants of the ``chunk_hash`` and f32 ``flash_attention`` kernels
on one CUDA card, beside an earlier version of each, in one process.

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/kv_parent
    python3 tools/kernel_variants.py [--parent build/kv_parent/src/repro_torch/kernels/csrc]

Builds, each by its own ``nvcc`` (all started together) into
``build/kernel_variants/``, copies of ``src/repro_torch/kernels/csrc/
chunk_hash.cu`` with its tuning constants rewritten:

- the committed kernel (one ``atomicAdd`` a block into a sum the
  launcher zeroes with ``cudaMemsetAsync``, finalized on the host; 1 uint4
  a thread, at most 528 blocks);
- 2 and 4 uint4s a thread; at most 264 blocks;

and of ``flash_attention.cu``: the committed kernel (a lane holds 4 q rows
x 4 keys, at most 8 warps a block, 2 blocks an SM, so at most 128
registers a thread), and at D = 32 4 key groups of 8 keys a lane (32-row
tiles), 8 q rows a lane with at most 7 warps and 2 blocks or 8 warps and
1 block; 8 keys a lane (64-key tiles); at most 16 warps and 1 block; with
``--parent``, the earlier ``chunk_hash.cu`` (its caller zeroes
the sum with a PyTorch fill) and ``flash_attention.cu`` of the
directory given, whose C interfaces are the ones before the redesign; and
``chip_smoke``'s empty kernel, whose profiler time is the launch floor.

Every variant is checked first: hashes equal ``hash_words_np`` at counts
0, 1, 5, 1023, 524,288 and 1,048,579 from view offsets 0-3 and after 300
repeated calls; attention within 2e-3 of the plain version at
(512, 200, 2, 32) f32, causal and not. Then each is timed at the smoke's
shapes, 524,288 words (in L2 after the first call, as in the smoke) and
(512, 200, 2, 32) f32 not causal (8 input sets, more than the L2), in
turns a, b, ..., b, a: the kernel's profiler time, all device time of one
call (memset or fill included) and one call between CUDA events. Prints
one JSON line last; exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "kernel_variants")


def _rewrite(src: str, pattern: str, repl: str) -> str:
    text, n = re.subn(pattern, repl, src)
    if n != 1:
        raise RuntimeError(f"source no longer matches {pattern!r} once; update "
                           "tools/kernel_variants.py")
    return text


def hash_variants() -> dict:
    """name -> chunk_hash.cu text, the committed kernel first."""
    src = open(os.path.join(CSRC, "chunk_hash.cu")).read()
    vec = r"constexpr int kVecPerThread = \d+;"
    return {
        "1 uint4 a thread, <= 528 blocks": src,
        "2 uint4 a thread": _rewrite(src, vec, "constexpr int kVecPerThread = 2;"),
        "4 uint4 a thread": _rewrite(src, vec, "constexpr int kVecPerThread = 4;"),
        "<= 264 blocks": _rewrite(src, r"constexpr int kMaxBlocks = 132 \* \d+;",
                                  "constexpr int kMaxBlocks = 132 * 2;"),
    }


def flash_variants() -> dict:
    """name -> flash_attention.cu text, the committed kernel first."""
    src = open(os.path.join(CSRC, "flash_attention.cu")).read()

    def consts(text, **values):
        for name, v in values.items():
            text = _rewrite(text, rf"constexpr int {name} = \d+;",
                            f"constexpr int {name} = {v};")
        return text

    def rows8(text):
        return _rewrite(text, r"static constexpr int RPL = 4; ",
                        "static constexpr int RPL = DP == 32 ? 8 : 4; ")

    return {
        "committed (D = 32: 8 key groups, 4 rows x 4 keys a lane)": src,
        "D = 32: 4 key groups, 4 rows x 8 keys a lane": _rewrite(
            src, r"static constexpr int KG = 8;", "static constexpr int KG = DP == 32 ? 4 : 8;"),
        "D = 32: 8 rows x 4 keys a lane, <= 7 warps": rows8(consts(src, kMaxWarps=7)),
        "D = 32: 8 rows x 4 keys a lane, 1 block an SM": rows8(consts(src, kMinBlocks=1)),
        "4 rows x 8 keys a lane (64-key tiles)": consts(src, kKeyTile=64),
        "<= 16 warps, 1 block an SM": consts(src, kMaxWarps=16, kMinBlocks=1),
    }


def build_all(sources: dict) -> dict:
    """{name: (file name, text)} -> {name: loaded library}, one nvcc each,
    all started together, with the build's flags for that file."""
    from repro_torch.kernels import build as kb

    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, (name, (fname, text)) in enumerate(sources.items()):
        cu, so = os.path.join(OUT, f"v{i}_{fname}"), os.path.join(OUT, f"v{i}.so")
        open(cu, "w").write(text)
        cmd = ([kb._nvcc()] + kb.ARCH_FLAGS + kb.COMMON_FLAGS
               + kb.EXTRA_FLAGS.get(fname, []) + ["-shared", cu, "-o", so])
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, p) in procs.items():
        text = p.communicate()[0].decode(errors="replace")
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        libs[name] = ctypes.CDLL(so)
    return libs


class Hash:
    """One chunk_hash library behind one call: ``start(words, n)`` launches
    and returns the device tensor the sum lands in, ``value(t, n)`` the
    hash. The parent's and the checkout's launchers take the same
    arguments; the parent's leaves the zeroing to its caller."""

    def __init__(self, lib, parent: bool):
        vp, i64 = ctypes.c_void_p, ctypes.c_longlong
        self.lib, self.parent = lib, parent
        lib.chunk_hash_launch.restype = ctypes.c_int
        lib.chunk_hash_launch.argtypes = [vp, i64, vp, vp]

    def start(self, words, n):
        import torch

        new = torch.zeros if self.parent else torch.empty  # the parent's fill
        out = new(1, dtype=torch.int32, device="cuda")
        err = self.lib.chunk_hash_launch(words.data_ptr(), n, out.data_ptr(),
                                         torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"chunk_hash_launch: cudaError_t {err}")
        return out

    def value(self, out, n) -> int:
        from repro_torch.kernels.chunk_hash.ref import finalize

        return finalize(int(out.item()) & 0xFFFFFFFF, n)


class Flash:
    def __init__(self, lib, parent: bool):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.lib, self.parent = lib, parent
        extra = [] if parent else [i32, i32]
        lib.flash_attention_f32_launch.argtypes = ([vp] * 4 + [i32] * 6 + [i64] * 9
                                                   + [ctypes.c_float, i32] + extra + [vp])
        lib.flash_attention_f32_launch.restype = i32

    def __call__(self, q, k, v, causal):
        import numpy as np
        import torch

        from repro_torch.kernels.flash_attention.ops import _vec16

        B, Sq, Hq, D = q.shape
        _, Sk, Hkv, _ = k.shape
        o = torch.empty_like(q)
        extra = () if self.parent else (int(_vec16(q)), int(_vec16(k) and _vec16(v)))
        err = self.lib.flash_attention_f32_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Sk, Hq, Hkv,
            D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(np.float32(1.0 / np.sqrt(D))), int(causal), *extra,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention_f32_launch: cudaError_t {err}")
        return o


def main(argv=None) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.chunk_hash.ref import hash_words_np
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="directory holding the earlier chunk_hash.cu "
                                     "and flash_attention.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: torch sees no CUDA device", file=sys.stderr)
        return 1
    sources = {f"hash: {n}": ("chunk_hash.cu", t) for n, t in hash_variants().items()}
    sources.update({f"flash: {n}": ("flash_attention.cu", t)
                    for n, t in flash_variants().items()})
    if args.parent:
        for fname, kind in (("chunk_hash.cu", "hash"), ("flash_attention.cu", "flash")):
            sources[f"{kind}: parent"] = (fname, open(os.path.join(args.parent, fname)).read())
    empty = cs.build_empty_kernel()
    libs = build_all(sources)
    hashes = {n: Hash(lib, n.endswith("parent")) for n, lib in libs.items()
              if n.startswith("hash")}
    flashes = {n: Flash(lib, n.endswith("parent")) for n, lib in libs.items()
               if n.startswith("flash")}

    failures, n_checks = [], 0
    rng = np.random.default_rng(0)
    big = rng.integers(0, 2**32, size=1_048_579 + 3, dtype=np.uint32)
    dev = torch.from_numpy(big).to("cuda")
    for name, h in hashes.items():
        for off in range(4):
            for n in (0, 1, 5, 1023, 524_288, 1_048_579):
                n_checks += 1
                got = h.value(h.start(dev[off:off + n], n), n)
                if got != hash_words_np(big[off:off + n]):
                    failures.append(dict(kernel=name, offset=off, words=n))
        outs = [h.start(dev, 524_288 - i) for i in range(300)]
        n_checks += 1
        if [h.value(o, 524_288 - i) for i, o in enumerate(outs)] != [
                hash_words_np(big[:524_288 - i]) for i in range(300)]:
            failures.append(dict(kernel=name, repeated_calls=300))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    sets = [tuple(torch.randn((512, 200, 2, 32), generator=gen, device="cuda")
                  for _ in range(3)) for _ in range(8)]
    for name, f in flashes.items():
        for causal in (False, True):
            n_checks += 1
            q, k, v = sets[0]
            err = float((f(q, k, v, causal) - flash_attention_torch(q, k, v, causal))
                        .abs().max())
            if not err <= 2e-3:
                failures.append(dict(kernel=name, causal=causal, max_abs_err=err))

    words = dev[:524_288]
    times = {n: dict(kernel_ms=[], device_ms=[], call_ms=[]) for n in libs}
    order = list(hashes) + list(flashes)
    for name in order + order[::-1]:
        t = times[name]
        if name in hashes:
            fn = lambda: hashes[name].start(words, 524_288)
            t["kernel_ms"].append(cs.kernel_ms(fn, "chunk_hash_kernel"))
        else:
            fn = cs._rotating(lambda q, k, v: flashes[name](q, k, v, False), sets)
            t["kernel_ms"].append(cs.kernel_ms(fn, "flash_kernel_f32"))
        t["device_ms"].append(cs.device_ms(fn))
        t["call_ms"].append(cs.time_ms(fn))
    floor_ms = [cs.kernel_ms(empty, "empty_kernel") for _ in range(2)]
    sass = {n: cs.sass_counts(lib._name, ("chunk_hash", "flash_kernel"),
                              ("ATOMG", "REDG", "HMMA", "HGMMA", "LDS.128",
                               "FFMA", "MUFU.EX2"))
            for n, lib in libs.items()}
    print(json.dumps(dict(card=cs.card_name(), checks=n_checks, failures=failures,
                          empty_kernel_ms=floor_ms, times=times, sass=sass)))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
