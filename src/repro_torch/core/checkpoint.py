"""The Check-N-Run checkpoint manager, single host, in PyTorch.

Orchestrates the paper's three-stage workflow (§3.4):

  1. in-memory snapshot (``repro_torch.core.snapshot`` — the only training
     stall)
  2. build an optimized checkpoint: incremental-policy row selection (§4.1)
     + row-wise quantization (§4.2). Each chunk of rows goes to
     ``config.device``, where the hand-written ``quant_pack`` kernel
     quantizes and bit-packs it and the ``chunk_hash`` kernel hashes the
     packed words (the plain PyTorch versions run when the device is the CPU)
  3. write to the object store through a bounded encode→write pipeline
     (``repro_torch.core.pipeline``), then atomically commit the manifest

plus recovery (baseline + increment replay through a streaming
fetch→decode→apply pipeline, decoded on the host), retention,
non-overlapping write scheduling with cancellation (straggler mitigation,
§3.3), and dynamic bit-width fallback (§5.2.1).

The store format is the reference package's (``src/repro``) byte for byte:
a store written by either package restores in the other. Sharded
multi-host writers (``num_hosts > 1``) and shard-only recovery
(``restore_part``) are not ported yet and raise ``NotImplementedError``.

Write-path threading model (see docs/write_path.md):

  trainer thread ──save()──▶ writer thread (select rows, feed pipeline)
                                  │ submit chunks, bounded window
                                  ├──▶ N encode workers (device
                                  │        quantize+pack+hash, layout,
                                  │        checksum)
                                  └──▶ M upload workers (store.put — IO)

Restore threading model: every chunk of the whole recovery chain streams
through a bounded fetch→decode→apply pipeline — increments prefetch while
the baseline is still dequantizing, decode runs on parallel workers, and a
single ordered applier preserves chain-replay overwrite order. In-flight
memory is O(pipeline window), not O(checkpoint).
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
import traceback
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
# a module import: kernels.adaptive_quant.ops imports core.packing, so it may
# still be initializing when this module runs
from ..kernels.adaptive_quant import ops as aq_ops
from ..kernels.chunk_hash.ops import chunk_hash32, hash_value, hash_words_async
from . import manifest as mf
from . import packing
from . import range_reader as rr
from . import tracker
from .bitwidth import BitwidthController
from .incremental import IncrementalPolicy, make_policy
from .integrity import ChunkCorruptionError, verify_chunk_bytes
from .metrics import ManagerMetrics
from .pipeline import RestorePipeline, WritePipeline
from .quantize import (
    PAPER_DEFAULTS,
    QuantConfig,
    Quantized,
    dequantize,
    quantize,
)
from .snapshot import Snapshot
from .storage import CheckpointCancelled, LocalFSStore, ObjectStore

# serve.delta_index is import-cycle-free by design (numpy-only at module
# scope; repro_torch.serve.__init__ is empty) — the writers stamp the
# serving layer's read-optimized delta index at commit time
# (docs/serving.md)
from ..serve.delta_index import build_delta, compress_spans

META_DTYPE = np.float16  # fp16 scale/zero metadata (halves per-row overhead)


@dataclasses.dataclass
class CheckpointConfig:
    interval_batches: int = 1000
    policy: str = "intermittent"          # full_only|one_shot|consecutive|intermittent
    quant: Optional[QuantConfig] = dataclasses.field(
        default_factory=lambda: PAPER_DEFAULTS[4])
    async_write: bool = True
    overlap: str = "wait"                  # "wait" | "cancel" (§3.3 non-overlap)
    keep_latest: int = 1
    ttl_days: float = 14.0
    chunk_rows: int = 65536                # §3.4: quantize/store pipelined chunks
    write_deadline_s: Optional[float] = None
    aux_bits: Optional[int] = None         # beyond-paper: quantize 1-D f32 row
                                           # aux (AdaGrad acc) per chunk (8-bit)
    # ---- write/restore engine (docs/write_path.md) ----
    pipeline: bool = True                  # False → window of 1 (serial order)
    encode_workers: int = 2                # chunk quantize+pack/checksum threads
    write_workers: int = 4                 # store.put threads
    max_inflight_chunks: Optional[int] = None  # encoded-payload window bound
    fused_pack: bool = True                # device-side bit packing (the
                                           # quant_pack kernel on a card, its
                                           # plain version on the CPU); False
                                           # → host pack_bits, same bytes
    restore_workers: int = 4               # parallel chunk fetch threads
    decode_workers: int = 2                # parallel unpack+dequant threads
    restore_inflight: Optional[int] = None  # fetched-chunk window bound
    chunk_hash: bool = True                # record a per-chunk content hash
                                           # (on device alongside quant_pack
                                           # — kernels/chunk_hash); decode
                                           # and `ckpt scan` verify it
    device: str = "cuda"                   # where chunks are quantized,
                                           # packed and hashed: the kernels
                                           # on a card, their plain versions
                                           # on "cpu"; "cuda" with no card
                                           # raises
    num_hosts: int = 1                     # >1 (sharded multi-host writers)
                                           # is not ported yet: raises


@dataclasses.dataclass
class SaveResult:
    step: int
    kind: str
    nbytes: int
    # build/write are BUSY times summed across workers (quantize + encode
    # threads / upload threads); with parallel workers they can exceed the
    # save's wall time. pipeline_stats carries wall_s + per-stage occupancy.
    build_time_s: float
    write_time_s: float
    cancelled: bool = False
    pipeline_stats: Optional[dict] = None


@dataclasses.dataclass
class RestoredState:
    step: int
    tables: Dict[str, np.ndarray]
    row_state: Dict[str, Dict[str, np.ndarray]]
    dense: Dict[str, np.ndarray]
    extra: Dict[str, Any]
    chain_len: int
    # restore-pipeline counters (wall_s, payload_bytes, occupancy per stage)
    stats: Optional[dict] = None
    # set when restore(on_corruption="fallback") replanned: the step the
    # caller ASKED for (corrupt); ``step`` is the older chain actually
    # restored — callers must treat the gap as lost training to redo
    degraded_from: Optional[int] = None


class _QuantClock:
    """Thread-safe accumulator for device quantize(+pack) seconds — the
    encode stage runs quantization on several workers, so per-chunk timings
    need a shared sink."""

    __slots__ = ("seconds", "_lock")

    def __init__(self) -> None:
        self.seconds = 0.0
        self._lock = threading.Lock()

    def add(self, dt: float) -> None:
        with self._lock:
            self.seconds += dt


class CheckNRunManager:
    """One manager per training job. Thread-safe for the single-trainer
    single-writer pattern the paper uses."""

    def __init__(
        self,
        store: ObjectStore,
        config: CheckpointConfig,
        bitwidth: Optional[BitwidthController] = None,
    ) -> None:
        if config.num_hosts > 1:
            raise NotImplementedError(
                "sharded multi-host writers (num_hosts > 1) are not ported "
                "to repro_torch yet; they come with the multi-host slice "
                "(dist/*, remote_store, object_server)")
        self.store = store
        self.config = config
        self.device = resolve_device(config.device)
        self.policy: IncrementalPolicy = make_policy(config.policy)
        self.bitwidth = bitwidth
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="cnr-writer")
        self._inflight: Optional[Future] = None
        self._cancel = threading.Event()
        # Touched-row bookkeeping (host side, see incremental.py semantics):
        self._cum_touched: Dict[str, np.ndarray] = {}     # since last committed FULL
        self._uncommitted: Dict[str, np.ndarray] = {}     # since last committed ckpt
        self._lock = threading.Lock()
        # Orphan-blob GC bookkeeping: steps whose save failed/cancelled in
        # THIS process (reclaimed cheaply after the next commit), plus one
        # full namespace sweep per process for debris a predecessor left.
        # Debris the sweep's fence skipped (newer than the then-latest
        # commit — e.g. a predecessor that crashed AHEAD of the restore
        # point) parks in _gc_pending until our own steps pass it.
        self._aborted_steps: set = set()
        self._gc_pending: set = set()
        self._gc_swept = False
        # Lifetime operational counters (ckpt emit-metrics / dashboards);
        # mutated on the writer thread AND the restoring thread, hence the
        # dedicated lock (NOT self._lock — metrics updates must never
        # contend with the touched-row hot path).
        self._metrics = ManagerMetrics()
        self._metrics_lock = threading.Lock()

    def _count(self, **deltas) -> None:
        """Add to counter fields / assign gauge fields of the metrics
        snapshot (None-valued gauges are assigned, counters summed)."""
        with self._metrics_lock:
            for k, v in deltas.items():
                cur = getattr(self._metrics, k)
                if isinstance(cur, int) and isinstance(v, int) and not k.startswith("last_"):
                    setattr(self._metrics, k, cur + v)
                else:
                    setattr(self._metrics, k, v)

    def metrics(self) -> ManagerMetrics:
        """One consistent snapshot of the manager's lifetime counters,
        merged with the store's logical counters and (remote stores) the
        transport's wire stats."""
        with self._metrics_lock:
            snap = dataclasses.replace(
                self._metrics,
                save_occupancy=dict(self._metrics.save_occupancy),
                restore_occupancy=dict(self._metrics.restore_occupancy))
        snap.store = self.store.counters.snapshot()
        stats = getattr(self.store, "stats", None)
        snap.remote = (stats.snapshot()
                       if stats is not None and hasattr(stats, "snapshot")
                       else {})
        snap.captured_unix = time.time()
        return snap

    # ------------------------------------------------------------------ save
    def save(self, snap: Snapshot, block: bool = False) -> Future:
        """Submit a snapshot for background checkpointing. Enforces the
        paper's non-overlap rule: wait for, or cancel, the in-flight write."""
        if self._inflight is not None and not self._inflight.done():
            if self.config.overlap == "cancel":
                self._cancel.set()
                try:
                    self._inflight.result()
                except Exception:
                    pass
            else:
                self._inflight.result()  # wait ("complete") — paper default
        self._cancel = threading.Event()

        with self._lock:
            for name, t in snap.touched.items():
                t = np.asarray(t, dtype=bool)
                self._cum_touched[name] = (
                    t if name not in self._cum_touched else self._cum_touched[name] | t)
                self._uncommitted[name] = (
                    t if name not in self._uncommitted else self._uncommitted[name] | t)
            cum = {k: v.copy() for k, v in self._cum_touched.items()}
            unc = {k: v.copy() for k, v in self._uncommitted.items()}

        cancel = self._cancel
        if self.config.async_write and not block:
            fut = self._pool.submit(self._write_guarded, snap, cum, unc, cancel)
        else:
            fut: Future = Future()
            try:
                fut.set_result(self._write_guarded(snap, cum, unc, cancel))
            except Exception as e:  # pragma: no cover
                fut.set_exception(e)
        self._inflight = fut
        return fut

    def wait(self) -> Optional[SaveResult]:
        if self._inflight is None:
            return None
        return self._inflight.result()

    def cancel_pending(self) -> None:
        self._cancel.set()

    def close(self) -> None:
        try:
            self.wait()
        except Exception:
            pass
        self._pool.shutdown(wait=True)

    # ------------------------------------------------------------- internals
    def _write_guarded(self, snap, cum, unc, cancel) -> SaveResult:
        try:
            res = self._write(snap, cum, unc, cancel)
        except CheckpointCancelled:
            self._aborted_steps.add(snap.step)
            self._count(saves_total=1, saves_cancelled=1)
            return SaveResult(step=snap.step, kind="cancelled", nbytes=0,
                              build_time_s=0.0, write_time_s=0.0, cancelled=True)
        except Exception:
            self._aborted_steps.add(snap.step)
            self._count(saves_total=1, saves_failed=1)
            traceback.print_exc()
            raise
        self._count(saves_total=1, saves_ok=1, save_bytes_total=res.nbytes,
                    last_success_step=res.step, last_success_unix=time.time(),
                    last_save_kind=res.kind,
                    save_occupancy=dict((res.pipeline_stats or {})
                                        .get("occupancy", {})))
        return res

    def _select_rows(self, decision: str, name: str, rows: int,
                     cum: Dict[str, np.ndarray], unc: Dict[str, np.ndarray],
                     row_range: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """Global indices of rows to store — restricted to ``row_range``
        (one host's shard of the table, ``[lo, hi)``) when given, so the
        union over the host partition equals the unsharded selection."""
        lo, hi = row_range if row_range is not None else (0, rows)
        if decision == "full":
            return np.arange(lo, hi, dtype=np.uint32)
        mask = cum.get(name) if self.policy.cumulative_mask else unc.get(name)
        if mask is None:  # untracked table -> always stored fully
            return np.arange(lo, hi, dtype=np.uint32)
        return tracker.shard_indices(mask, lo, hi)

    def _quant_config(self) -> Optional[QuantConfig]:
        if self.bitwidth is not None:
            return self.bitwidth.current_config()
        return self.config.quant

    # ------------------------------------------------------ chunk quantization
    def _payload_hash32(self, payload: bytes) -> Optional[int]:
        """Host-side content hash of a serialized section (the fallback
        when the packed words never lived on device)."""
        if not self.config.chunk_hash:
            return None
        return chunk_hash32(payload)

    def _quant_encode(self, rows_arr: np.ndarray, qcfg: QuantConfig):
        """Quantize + bit-pack one chunk of rows. Returns (scale f32,
        zero f32, packed-codes payload bytes, hash32-or-None).

        Fast path (``fused_pack``): the rows go to ``config.device``, where
        ``quant_pack`` emits the packed word stream — only ``bits/8`` bytes
        per code cross back to the host and the encode stage shrinks to
        header assembly. The host fallback (``fused_pack=False``) runs the
        SAME quantizer, then ``packing.pack_bits``; both paths produce
        byte-identical payloads. Methods the fused op does not take
        (uniform_sym) quantize through ``core.quantize``.

        With ``chunk_hash`` the fused path also hashes the packed word
        stream ON DEVICE (kernels/chunk_hash) before it crosses to the
        host — the hash witnesses the bytes as the accelerator produced
        them, a coverage the host-computed crc32 cannot give. The host
        fallbacks hash the serialized payload; byte-identical payloads
        mean identical hashes either way."""
        if qcfg.method in ("adaptive", "uniform_asym"):
            x = torch.from_numpy(
                np.ascontiguousarray(rows_arr, dtype=np.float32)).to(self.device)
            kw = dict(bits=qcfg.bits, method=qcfg.method,
                      num_bins=qcfg.num_bins, ratio=qcfg.ratio)
            if self.config.fused_pack:
                pq = aq_ops.quant_pack(x, **kw)
                h, n_words = None, 0
                if self.config.chunk_hash:
                    # hash exactly the words the payload serializes:
                    # ceil(payload_nbytes / 4), tail bits zero by packing.
                    # Launched behind quant_pack; its 4 bytes come back
                    # with the copies below, which synchronize the stream.
                    n_words = ((int(pq.count) * qcfg.bits + 7) // 8 + 3) // 4
                    h = hash_words_async(pq.words, count=n_words)
                    h = h.to("cpu", non_blocking=True)
                scale, zero = pq.scale.cpu().numpy(), pq.zero.cpu().numpy()
                words = pq.words.cpu().numpy()
                return (scale, zero,
                        packing.words_to_payload(words, pq.count, qcfg.bits),
                        None if h is None else hash_value(h, n_words))
            q = aq_ops.quant_codes(x, **kw)
            payload = packing.pack_bits(q.codes.cpu().numpy(), qcfg.bits)
            return (q.scale.cpu().numpy(), q.zero.cpu().numpy(), payload,
                    self._payload_hash32(payload))
        q = quantize(torch.from_numpy(
            np.ascontiguousarray(rows_arr, dtype=np.float32)), qcfg)
        payload = packing.pack_bits(q.codes.numpy(), qcfg.bits)
        return (q.scale.numpy(), q.zero.numpy(), payload,
                self._payload_hash32(payload))

    # ------------------------------------------------- shared write plumbing
    def _make_pipeline(self, cancel, deadline) -> WritePipeline:
        cfg = self.config
        if cfg.pipeline:
            return WritePipeline(encode_workers=cfg.encode_workers,
                                 write_workers=cfg.write_workers,
                                 max_inflight=cfg.max_inflight_chunks,
                                 cancel=cancel, deadline=deadline)
        # window of 1 → chunks encode and write strictly one at a time
        return WritePipeline(encode_workers=1, write_workers=1,
                             max_inflight=1, cancel=cancel, deadline=deadline)

    def _submit_table_chunks(self, pipe: WritePipeline, name: str,
                             tab: np.ndarray, sel: np.ndarray, aux,
                             qcfg: Optional[QuantConfig], full: bool,
                             key_prefix: str,
                             clock: Optional[_QuantClock] = None
                             ) -> List[Future]:
        """Stage 0 (writer/host thread): slice the selection into chunks and
        submit one encode→write job per chunk. Quantization happens INSIDE
        the encode jobs (one fused dispatch per chunk), so it parallelizes
        across encode workers and overlaps uploads — the writer thread only
        feeds the window. The ONE implementation of the chunk byte format's
        emission — single-host and per-host shard writers both go through
        here (key_prefix is the only difference), which is what keeps their
        restores byte-identical. Returns the chunk futures; device quantize
        seconds accumulate into ``clock``."""
        cfg = self.config
        futs: List[Future] = []
        for seq, blo in enumerate(range(0, len(sel), cfg.chunk_rows)):
            idx = sel[blo: blo + cfg.chunk_rows]
            key = f"{key_prefix}{name}/{seq:06d}.bin"
            encode_fn = functools.partial(
                self._encode_chunk_job, key, tab, idx, aux, qcfg, full, clock)
            write_fn = functools.partial(self.store.put, key)
            futs.append(pipe.submit(encode_fn, write_fn))
        return futs

    def _make_table_record(self, rows: int, dim: int, dtype: str, aux,
                           qcfg: Optional[QuantConfig],
                           chunks: List[mf.ChunkRecord]) -> mf.TableRecord:
        return mf.TableRecord(
            rows=rows, dim=dim, dtype=dtype,
            bits=qcfg.bits if qcfg else None,
            method=qcfg.method if qcfg else None,
            row_state={a: str(v.dtype) for a, v in aux.items()},
            chunks=chunks,
            meta_dtype=str(np.dtype(META_DTYPE)) if qcfg else None)

    # ------------------------------------------------------------- the write
    def _write(self, snap: Snapshot, cum, unc, cancel: threading.Event) -> SaveResult:
        t_start = time.monotonic()
        step = snap.step
        decision = self.policy.decide(step)
        qcfg = self._quant_config()
        qcfg = qcfg.resolve() if qcfg is not None else None
        cfg = self.config

        deadline = (time.monotonic() + cfg.write_deadline_s
                    if cfg.write_deadline_s else None)
        pipe = self._make_pipeline(cancel, deadline)

        clock = _QuantClock()
        table_futs: Dict[str, List[Future]] = {}
        table_shape: Dict[str, Tuple[int, int, str, Dict[str, np.ndarray]]] = {}
        dense_futs: Dict[str, Future] = {}
        try:
            for name, tab in snap.tables.items():
                rows, dim = tab.shape
                sel = self._select_rows(decision, name, rows, cum, unc)
                aux = snap.row_state.get(name, {})
                table_futs[name] = self._submit_table_chunks(
                    pipe, name, tab, sel, aux, qcfg, decision == "full",
                    mf.chunk_prefix(step), clock)
                table_shape[name] = (rows, dim, str(tab.dtype), aux)

            for key_name, arr in snap.dense.items():
                key = (f"{mf.chunk_prefix(step)}dense/"
                       f"{mf.sanitize_key(key_name)}.bin")
                encode_fn = functools.partial(self._encode_dense_job, key, arr)
                write_fn = functools.partial(self.store.put, key)
                dense_futs[key_name] = pipe.submit(encode_fn, write_fn)

            pipe.drain()  # raises the first error / CheckpointCancelled
        finally:
            pipe.close()

        # All futures settled successfully — assemble the manifest in
        # deterministic submission order and commit atomically.
        tables: Dict[str, mf.TableRecord] = {}
        total_bytes = 0
        for name, futs in table_futs.items():
            rows, dim, dtype, aux = table_shape[name]
            chunks = [f.result() for f in futs]
            total_bytes += sum(c.nbytes for c in chunks)
            tables[name] = self._make_table_record(rows, dim, dtype, aux,
                                                   qcfg, chunks)
        dense: Dict[str, mf.DenseRecord] = {}
        for key_name, fut in dense_futs.items():
            dense[key_name] = fut.result()
            total_bytes += dense[key_name].nbytes

        prev = mf.latest_step(self.store)
        base = (step if decision == "full" else self.policy.state.baseline_step)
        stats = pipe.stats
        man = mf.Manifest(
            step=step, kind=decision, base_step=base,
            prev_step=prev, quant=(dataclasses.asdict(qcfg) if qcfg else None),
            policy=self.policy.to_dict() | {"name": self.policy.name},
            tables=tables, dense=dense,
            extra=snap.extra | {"bitwidth": self.bitwidth.to_dict() if self.bitwidth else None},
            nbytes_total=total_bytes,
            wall_time_s=time.monotonic() - t_start,
            created_unix=time.time(),
            layout=mf.make_layout(1),
            delta=build_delta(tables, dense))
        mf.commit(self.store, man)

        self._post_commit(step, decision, total_bytes)
        return SaveResult(
            step=step, kind=decision, nbytes=total_bytes,
            # quantization runs inside the encode stage now, so its busy
            # seconds are a SUBSET of encode_busy_s (quantize_s reports it)
            build_time_s=stats.encode_busy_s,
            write_time_s=stats.write_busy_s,
            pipeline_stats=dict(
                items=stats.items, payload_bytes=stats.payload_bytes,
                encode_busy_s=stats.encode_busy_s,
                write_busy_s=stats.write_busy_s,
                quantize_s=clock.seconds, wall_s=stats.wall_s,
                occupancy=pipe.occupancy()))

    def _post_commit(self, step: int, decision: str, nbytes: int) -> None:
        """Bookkeeping once the manifest is durable: advance the policy,
        reset touched-row masks, apply retention, and reclaim the debris of
        earlier aborted/cancelled saves (safe here — the non-overlap rule
        means no other save is in flight)."""
        self.policy.observe(step, decision, nbytes)
        with self._lock:
            if decision == "full":
                self._cum_touched = {k: np.zeros_like(v)
                                     for k, v in self._cum_touched.items()}
            self._uncommitted = {k: np.zeros_like(v)
                                 for k, v in self._uncommitted.items()}
        retained = mf.apply_retention(self.store, self.config.keep_latest,
                                      self.config.ttl_days)
        if retained:
            self._count(retention_steps_deleted_total=len(retained))
        # Reclaim aborted/cancelled saves' debris: one full sweep per
        # process (debris a crashed predecessor left), then only the steps
        # this process actually aborted — keeps the post-commit cost
        # independent of store size on the happy path. Steps the sweep's
        # fence had to skip (a predecessor crashed at a step AHEAD of our
        # restore point) are reclaimed as soon as our committed steps
        # catch up — past `step` they can no longer be an in-flight save.
        if not self._gc_swept:
            swept = mf.gc_aborted(self.store, skipped_out=self._gc_pending)
            if swept:
                self._count(gc_steps_reclaimed_total=len(swept),
                            gc_keys_reclaimed_total=sum(swept.values()))
            if isinstance(self.store, LocalFSStore):
                # terminated writers' half-written temp files are invisible
                # to the manifest-level GC (list() filters them)
                self.store.reclaim_tmp()
            self._gc_swept = True
        due = {s for s in self._gc_pending if s <= step}
        if self._aborted_steps or due:
            reclaimed = mf.gc_steps(self.store, self._aborted_steps | due)
            if reclaimed:
                self._count(gc_steps_reclaimed_total=len(reclaimed),
                            gc_keys_reclaimed_total=sum(reclaimed.values()))
            self._gc_pending -= due
        self._aborted_steps.clear()

    # ---------------------------------------------------------- encode stage
    def _encode_chunk_job(self, key: str, tab, idx, aux, qcfg, full, clock):
        payload, sections, hash32 = self._encode_chunk(tab, idx, aux, qcfg,
                                                       full, clock)
        row_range = ([int(idx[0]), int(idx[-1]) + 1]
                     if full and len(idx) else None)
        # incremental chunks record compressed global-row spans — the delta
        # index's raw material and a tighter planner bound than the writer
        # shard (full chunks are exactly range-encoded already)
        row_spans = (compress_spans(idx)
                     if not full and len(idx) else None)
        rec = mf.ChunkRecord(
            key=key, n_rows=int(len(idx)), nbytes=len(payload),
            crc32=ObjectStore.checksum(payload), sections=sections,
            row_range=row_range, hash32=hash32, row_spans=row_spans)
        return payload, rec

    def _encode_dense_job(self, key: str, arr: np.ndarray):
        data = np.ascontiguousarray(arr).tobytes()
        rec = mf.DenseRecord(
            key=key, shape=list(arr.shape), dtype=str(arr.dtype),
            nbytes=len(data), crc32=ObjectStore.checksum(data))
        return data, rec

    def _encode_chunk(self, tab: np.ndarray, idx: np.ndarray,
                      aux: Dict[str, np.ndarray], qcfg: Optional[QuantConfig],
                      full: bool, clock: Optional[_QuantClock] = None):
        """Serialize one chunk of rows: [indices?][scale][zero][codes][aux...]
        (full-checkpoint chunks are contiguous → range-encoded, no indices).
        Returns (payload, sections, hash32) — hash32 covers the PRIMARY
        section (codes / values; ``integrity.primary_section``), computed
        on device for the fused path.

        With the fused quantize+pack path the quantized sections arrive
        packed from the device, so this reduces to header assembly: section
        offsets, fp16 metadata casts, and the aux encodings."""
        parts = []
        sections: Dict[str, list] = {}
        off = 0
        hash32: Optional[int] = None

        def add(nm: str, b: bytes):
            nonlocal off
            sections[nm] = [off, len(b)]
            parts.append(b)
            off += len(b)

        if not full:
            add("indices", np.ascontiguousarray(idx, dtype=np.uint32).tobytes())
        if qcfg is not None and len(idx):
            # full-checkpoint chunks are ascending ranges → contiguous view
            rows_arr = (tab[int(idx[0]):int(idx[-1]) + 1] if full
                        else tab[idx])
            t0 = time.monotonic()
            scale, zero, codes_payload, hash32 = self._quant_encode(rows_arr,
                                                                    qcfg)
            if clock is not None:
                clock.add(time.monotonic() - t0)
            # fp16 quantization metadata (beyond-paper: the paper flags its
            # metadata structure as unoptimized; fp16 scale/zero costs <1e-3
            # relative dequant error and halves the per-row overhead)
            add("scale", np.asarray(scale, dtype=META_DTYPE).tobytes())
            add("zero", np.asarray(zero, dtype=META_DTYPE).tobytes())
            add("codes", codes_payload)
        else:
            values = np.ascontiguousarray(tab[idx], dtype=np.float32).tobytes()
            hash32 = self._payload_hash32(values)
            add("values", values)
        for a_name, a_arr in aux.items():
            vals = a_arr[idx]
            if (self.config.aux_bits == 8 and vals.ndim == 1
                    and vals.dtype == np.float32 and len(idx)):
                # per-chunk 8-bit asymmetric: [f32 lo][f32 hi][u8 codes]
                lo, hi = float(vals.min()), float(vals.max())
                # float64 throughout: a float32 `(hi - lo) / 255` underflows
                # for subnormal spans (inf/nan codes); float64 keeps the
                # nearest-code rounding exact for every representable span
                scale8 = (hi - lo) / 255.0 or 1.0
                codes8 = np.clip(np.round((vals.astype(np.float64) - lo)
                                          / scale8), 0, 255).astype(np.uint8)
                add(f"aux8:{a_name}", np.array([lo, hi], np.float32).tobytes()
                    + codes8.tobytes())
            else:
                add(f"aux:{a_name}", np.ascontiguousarray(vals).tobytes())
        return b"".join(parts), sections, hash32

    # --------------------------------------------------------------- restore
    def restore(self, step: Optional[int] = None,
                on_corruption: str = "raise") -> RestoredState:
        """Restore the model state at ``step`` (default: newest committed).

        ``on_corruption`` controls what happens when a blob in the chain
        fails integrity verification (:class:`ChunkCorruptionError`):

        * ``"raise"`` (default) — propagate the typed error; the caller
          decides (paper semantics: restore what was asked or fail).
        * ``"fallback"`` — replan onto the newest committed chain that
          does NOT pass through any step observed corrupt so far, retrying
          until one restores or candidates run out (then the ORIGINAL
          error propagates). A degraded restore sets
          ``RestoredState.degraded_from`` to the step originally asked
          for — training silently resuming from older state must at least
          be loud in the result.
        """
        if on_corruption not in ("raise", "fallback"):
            raise ValueError(f"on_corruption must be 'raise' or 'fallback', "
                             f"got {on_corruption!r}")
        store = self.store
        if step is None:
            step = mf.latest_step(store)
        if step is None:
            raise FileNotFoundError("no valid checkpoint found")
        try:
            return self._restore_at(step)
        except ChunkCorruptionError as e:
            self._count(corruption_errors_total=1)
            if on_corruption != "fallback":
                raise
            return self._restore_fallback(step, e)

    def _restore_fallback(self, target: int,
                          first_err: ChunkCorruptionError) -> RestoredState:
        """Retry restore on progressively older committed chains, skipping
        every chain that passes through a step already observed corrupt."""
        store = self.store
        bad = {first_err.step if first_err.step is not None else target}
        tried = {target}
        while True:
            candidate = None
            for s in sorted(mf.list_steps(store), reverse=True):
                if s in tried or s in bad:
                    continue
                try:
                    chain_steps = {m.step
                                   for m in mf.recovery_chain(store, s)}
                except (ValueError, KeyError, FileNotFoundError):
                    tried.add(s)
                    continue
                if chain_steps & bad:
                    tried.add(s)  # poisoned upstream — never retry it
                    continue
                candidate = s
                break
            if candidate is None:
                raise first_err
            tried.add(candidate)
            try:
                out = self._restore_at(candidate)
            except ChunkCorruptionError as e:
                self._count(corruption_errors_total=1)
                bad.add(e.step if e.step is not None else candidate)
                continue
            out.degraded_from = target
            self._count(restore_fallbacks_total=1)
            return out

    def _restore_at(self, step: int) -> RestoredState:
        store = self.store
        try:
            chain = mf.recovery_chain(store, step)
        except (KeyError, FileNotFoundError) as e:
            # a chain manifest is gone (quarantined or reclaimed) — typed,
            # so on_corruption="fallback" can replan around it
            raise ChunkCorruptionError(
                step, None, mf.manifest_key(step), "broken-chain",
                f"recovery chain unreadable: {e}") from e
        except ValueError as e:
            raise ChunkCorruptionError(
                step, None, mf.manifest_key(step), "broken-chain",
                str(e)) from e

        tables: Dict[str, np.ndarray] = {}
        row_state: Dict[str, Dict[str, np.ndarray]] = {}
        dense: Dict[str, np.ndarray] = {}

        def alloc(name: str, rec: mf.TableRecord):
            return np.zeros((rec.rows, rec.dim), dtype=np.float32), 0

        plan = rr.plan_ranges(chain)
        stats = self._replay_plan(plan, tables, row_state, dense, alloc)
        final = chain[-1]
        # Resync host bookkeeping + policy so saves after restore are coherent.
        self.policy.load_dict(final.policy)
        if self.bitwidth is not None and final.extra.get("bitwidth"):
            self.bitwidth.load_dict(final.extra["bitwidth"])
            self.bitwidth.on_restore()
        with self._lock:
            self._cum_touched = {}
            self._uncommitted = {}
        self._count(restores_total=1,
                    restore_bytes_total=int(stats.get("payload_bytes", 0)),
                    last_restore_step=final.step,
                    restore_occupancy=dict(stats.get("occupancy", {})))
        return RestoredState(step=final.step, tables=tables, row_state=row_state,
                             dense=dense, extra=final.extra,
                             chain_len=len(chain), stats=stats)

    def restore_part(self, host: int, step: Optional[int] = None,
                     num_hosts: Optional[int] = None) -> RestoredState:
        """Shard-only recovery of one host's rows: not ported yet."""
        raise NotImplementedError(
            "restore_part (shard-only partial recovery) is not ported to "
            "repro_torch yet; it comes with the partial-recovery slice "
            "(restore_part, splice_shard_state, Trainer.recover_host)")

    # ------------------------------------------------- streaming plan replay
    def _replay_plan(self, plan: "rr.RangePlan",
                     tables: Dict[str, np.ndarray],
                     row_state: Dict[str, Dict[str, np.ndarray]],
                     dense: Dict[str, np.ndarray], alloc_fn) -> dict:
        """Stream a range plan's chunks through one bounded
        fetch→decode→apply pipeline (docs/write_path.md, "decode path").

        All planned reads are submitted up front (the window bounds
        in-flight memory to O(window)), so increment chunks prefetch from
        the store while the baseline is still being dequantized and
        applied. Fetch and decode run concurrently and out of order; the
        single ordered applier scatters in submission order, which IS the
        plan's chain order — a later manifest's rows always overwrite an
        earlier one's. ``alloc_fn(name, rec) -> (array, row_offset)``
        sizes the output (whole table or one target shard); chunks whose
        row bound straddles a target boundary are clipped in the decode
        stage (``range_reader.clip_decoded``) so only intersecting rows
        are scattered. The final manifest's dense params ride the same
        pipeline."""
        cfg = self.config
        final_man = plan.chain[-1]
        offsets: Dict[str, int] = {}

        def decode_clipped(step, name, rec, ch, tlo, thi, data):
            return rr.clip_decoded(
                self._decode_chunk(step, name, rec, ch, data), tlo, thi)

        # allocate on first MENTION in the chain (not first planned read):
        # a table whose target shard is empty, or whose increments touched
        # nothing, must still appear in the result with its (possibly
        # zero-row) array and range recorded
        for man in plan.chain:
            for name, rec in man.tables.items():
                if plan.targets is not None and name not in plan.targets:
                    continue
                if name not in tables:
                    tables[name], offsets[name] = alloc_fn(name, rec)
                    row_state[name] = {}  # aux allocated lazily (width
                    #                       varies by checkpoint config)
        pipe = RestorePipeline(fetch_workers=cfg.restore_workers,
                               decode_workers=cfg.decode_workers,
                               max_inflight=cfg.restore_inflight)
        try:
            for pr in plan.reads:
                name, rec, ch = pr.table, pr.rec, pr.chunk
                if plan.targets is None:
                    decode = functools.partial(self._decode_chunk,
                                               pr.man.step, name, rec, ch)
                else:
                    tlo, thi = plan.targets[name]
                    if pr.bound[0] >= tlo and pr.bound[1] <= thi:
                        # bound (hence every row) inside the target
                        decode = functools.partial(self._decode_chunk,
                                                   pr.man.step, name, rec,
                                                   ch)
                    else:
                        decode = functools.partial(decode_clipped,
                                                   pr.man.step, name, rec,
                                                   ch, tlo, thi)
                pipe.submit(
                    functools.partial(self.store.get, ch.key),
                    decode,
                    functools.partial(self._apply_decoded, tables[name],
                                      row_state[name], rec, ch,
                                      offsets[name]))
            for key_name, drec in final_man.dense.items():
                pipe.submit(
                    functools.partial(self.store.get, drec.key),
                    functools.partial(self._decode_dense, final_man.step,
                                      key_name, drec),
                    functools.partial(dense.__setitem__, key_name))
            pipe.drain()
        finally:
            pipe.close()
        return dict(items=pipe.stats.items,
                    payload_bytes=pipe.stats.payload_bytes,
                    wall_s=pipe.stats.wall_s,
                    busy={k: round(v, 6)
                          for k, v in pipe.stats.busy.items()},
                    occupancy={k: round(v, 4)
                               for k, v in pipe.occupancy().items()})

    # ---------------------------------------------------------- decode stage
    def _decode_chunk(self, step: Optional[int], table: Optional[str],
                      rec: mf.TableRecord, ch: mf.ChunkRecord,
                      data: bytes):
        return decode_chunk(step, table, rec, ch, data)

    def _apply_decoded(self, out: np.ndarray,
                       aux_out: Dict[str, np.ndarray], rec: mf.TableRecord,
                       ch: mf.ChunkRecord, row_offset: int, decoded) -> None:
        apply_decoded(out, aux_out, rec, ch, row_offset, decoded)

    def _decode_dense(self, step: Optional[int], name: Optional[str],
                      rec: mf.DenseRecord, data: bytes) -> np.ndarray:
        return decode_dense(step, name, rec, data)


# Module-level decode/apply stages: shared by the manager's restore path
# and the serving subscriber (repro.serve.subscriber), which replays the
# same chunks without a CheckpointManager. None of them touch manager
# state — a chunk decodes the same way no matter who asked.
def decode_chunk(step: Optional[int], table: Optional[str],
                 rec: mf.TableRecord, ch: mf.ChunkRecord,
                 data: bytes):
    """Verify + unpack + dequantize one chunk (decode workers, CPU).
    Returns (global row idx, row values, {aux: (vals, width, dtype)}).
    Integrity failures raise :class:`ChunkCorruptionError` carrying
    step/table/key — ``restore(on_corruption="fallback")`` replans on
    it, and operators see WHICH step to ``ckpt quarantine`` instead of
    a bare checksum message."""
    dim = rec.dim
    verify_chunk_bytes(ch, data, step, table)
    if "indices" in ch.sections:
        o, n = ch.sections["indices"]
        idx = np.frombuffer(data[o:o + n], dtype=np.uint32).astype(np.int64)
    else:
        lo, hi = ch.row_range
        idx = np.arange(lo, hi, dtype=np.int64)
    if "values" in ch.sections:
        o, n = ch.sections["values"]
        vals = np.frombuffer(data[o:o + n], dtype=np.float32).reshape(-1, dim)
    else:
        o, n = ch.sections["scale"]
        if rec.meta_dtype is not None:
            meta_dt = np.dtype(rec.meta_dtype)
        else:  # pre-meta_dtype manifests: sniff fp16 by section length
            meta_dt = np.float16 if n == 2 * ch.n_rows else np.float32
        scale = np.frombuffer(data[o:o + n], dtype=meta_dt).astype(np.float32)
        o, n = ch.sections["zero"]
        zero = np.frombuffer(data[o:o + n], dtype=meta_dt).astype(np.float32)
        o, n = ch.sections["codes"]
        codes = packing.unpack_bits(data[o:o + n], rec.bits, ch.n_rows * dim)
        q = Quantized(torch.from_numpy(codes.reshape(-1, dim)),
                      torch.from_numpy(scale), torch.from_numpy(zero),
                      bits=rec.bits)
        vals = dequantize(q).numpy()
    aux: Dict[str, Tuple[np.ndarray, int, np.dtype]] = {}
    for a_name, a_dt in rec.row_state.items():
        sec8 = ch.sections.get(f"aux8:{a_name}")
        sec = ch.sections.get(f"aux:{a_name}")
        if sec8 is not None:
            o, n = sec8
            lo, hi = np.frombuffer(data[o:o + 8], dtype=np.float32)
            codes = np.frombuffer(data[o + 8:o + n], dtype=np.uint8)
            # float64 scale arithmetic on Python floats, matching the
            # ENCODER exactly: float32 `(hi - lo) / 255.0` underflows
            # for near-zero ranges, distorting the dequant scale (and
            # a zero scale would collapse every row to `lo`)
            lo, hi = float(lo), float(hi)
            scale8 = (hi - lo) / 255.0 or 1.0
            a_vals = (codes.astype(np.float64) * scale8 + lo).astype(
                np.float32)
        elif sec is None:
            continue
        else:
            o, n = sec
            a_vals = np.frombuffer(data[o:o + n], dtype=np.dtype(a_dt))
        width = a_vals.size // max(ch.n_rows, 1)
        aux[a_name] = (a_vals, width, np.dtype(a_dt))
    return idx, vals, aux


def apply_decoded(out: np.ndarray,
                  aux_out: Dict[str, np.ndarray], rec: mf.TableRecord,
                  ch: mf.ChunkRecord, row_offset: int, decoded) -> None:
    """Scatter one decoded chunk (the single ordered applier thread —
    chain-replay overwrite order is preserved by submission order, so
    no locking is needed here). ``row_offset`` shifts the chunk's
    global row indices into a shard-local ``out`` (restore_part)."""
    idx, vals, aux = decoded
    if row_offset:
        idx = idx - row_offset
    out[idx] = vals
    for a_name, (a_vals, width, a_dt) in aux.items():
        if a_name not in aux_out:
            rows = out.shape[0]  # == rec.rows unless shard-local
            shape = (rows,) if width == 1 else (rows, width)
            aux_out[a_name] = np.zeros(shape, dtype=a_dt)
        if width == 1:
            aux_out[a_name][idx] = a_vals
        else:
            aux_out[a_name][idx] = a_vals.reshape(-1, width)


def decode_dense(step: Optional[int], name: Optional[str],
                 rec: mf.DenseRecord, data: bytes) -> np.ndarray:
    got = ObjectStore.checksum(data)
    if got != rec.crc32:
        raise ChunkCorruptionError(
            step, name, rec.key, "crc32-mismatch",
            f"got {got:#010x}, manifest records {rec.crc32:#010x}")
    return np.frombuffer(
        data, dtype=np.dtype(rec.dtype)).reshape(rec.shape).copy()
