"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) into an object, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``<checkout>/build/`` under a name keyed on a hash of the
sources and flags, so a checkout builds once and an edited source rebuilds.

Nothing here runs at import time: :func:`library` builds on first use, so
modules that hold kernels import on a machine without ``nvcc`` or a card.
A build that fails raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Per-source extra flags. The two quantizers keep every multiply and add
# separately rounded so their error sums round like their plain versions'.
EXTRA_FLAGS = {"quant_pack.cu": ["-fmad=false"],
               "adaptive_quant.cu": ["-fmad=false"]}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
last_build_s: Optional[float] = None  # seconds the last build took, None if cached


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _build_key(sources) -> str:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
        h.update(" ".join(EXTRA_FLAGS.get(src.name, [])).encode())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(ARCH_FLAGS + COMMON_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(out: Path, sources) -> None:
    import time

    t0 = time.monotonic()
    nvcc = _nvcc()
    work = out.parent / f"{out.stem}.tmp{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        obj = work / (src.stem + ".o")
        cmd = ([nvcc] + ARCH_FLAGS + COMMON_FLAGS + EXTRA_FLAGS.get(src.name, [])
               + ["-c", str(src), "-o", str(obj)])
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    log, objs, failed = [], [], []
    for src, obj, p in procs:
        text = p.communicate()[0].decode(errors="replace")
        log.append(f"== {src.name}\n{text}")
        objs.append(str(obj))
        if p.returncode != 0:
            failed.append(src.name)
    (out.parent / f"{out.stem}.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp_so = work / out.name
    link = subprocess.run([nvcc] + ARCH_FLAGS + ["-shared", "-o", str(tmp_so)]
                          + objs, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n"
                           + link.stdout.decode(errors="replace"))
    os.replace(tmp_so, out)
    shutil.rmtree(work, ignore_errors=True)
    global last_build_s
    last_build_s = time.monotonic() - t0


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.quant_pack_launch.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                      i32, i64, vp]
    lib.quant_pack_launch.restype = i32
    lib.chunk_hash_launch.argtypes = [vp, i64, vp, vp]
    lib.chunk_hash_launch.restype = i32
    lib.embedding_bag_launch.argtypes = ([ctypes.POINTER(vp), ctypes.POINTER(i64), i32,
                                          vp, i64, i64, i64, vp] + [i32] * 4 + [vp])
    lib.embedding_bag_launch.restype = i32
    lib.dot_interaction_launch.argtypes = [vp, vp, i32, i32, i32, i32, vp]
    lib.dot_interaction_launch.restype = i32
    lib.adaptive_quant_launch.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                          i32, vp]
    lib.adaptive_quant_launch.restype = i32
    lib.flash_attention_f32_launch.argtypes = ([vp] * 4 + [i32] * 6 + [i64] * 9
                                               + [ctypes.c_float, i32, i32, i32, vp])
    lib.flash_attention_f32_launch.restype = i32
    lib.flash_attention_mma_launch.argtypes = ([vp] * 4 + [i32] * 6 + [i64] * 9
                                               + [ctypes.c_float, i32, i32, i32, vp])
    lib.flash_attention_mma_launch.restype = i32


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this checkout lacks it."""
    global _lib
    with _lock:
        if _lib is None:
            sources = _sources()
            out = BUILD_DIR / f"repro_torch_kernels-{_build_key(sources)}.so"
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                _build(out, sources)
            lib = ctypes.CDLL(str(out))
            _bind(lib)
            _lib = lib
        return _lib


class LaunchCounter:
    """Kernel launches made by one wrapper, safe across the encode workers'
    threads. A wrapper adds one where it launches its kernel, and nowhere
    else, so a run can show that its path went through the kernel."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        with self._lock:
            return self._n


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: cudaError_t {err}")
