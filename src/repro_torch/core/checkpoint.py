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
a store written by either package restores in the other. With
``num_hosts > 1`` each save goes through per-host shard writers, threads
of this process that each run their own encode→write pipeline over one
row-shard, and a coordinator-less two-phase commit
(``repro_torch.dist.shard_writer``); with ``multiprocess=True`` each host
is its own OS process (``repro_torch.dist.host_proc``), which quantizes
and hashes its chunks on ``config.device`` itself. ``restore_part``
replays one host's shard alone (partial recovery and resharding).

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
import os
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
from .coordinator import CommitContext
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
    # ---- sharded multi-host writers (docs/sharded_writers.md) ----
    num_hosts: int = 1                     # >1 → per-host shard writers with
                                           # two-phase manifest commit
    verify_shard_chunks: bool = True       # committing host re-checks every
                                           # chunk's existence+size pre-commit
    multiprocess: bool = False             # num_hosts>1: real OS processes
                                           # over a LocalFSStore root or a
                                           # remote store URI (multi-pod, no
                                           # shared FS) instead of
                                           # thread-simulated hosts
    spill_dir: Optional[str] = None        # scratch dir for multiprocess
                                           # snapshot spills (default: tmp)
    batch_fsync: bool = False              # LocalFSStore: defer chunk dirent
                                           # fsyncs to the pre-vote flush
                                           # (same crash-safety point)
    remote_fault: Optional[str] = None     # test-only: seeded FaultSpec
                                           # ("k=v,k=v") injected under each
                                           # host process's remote transport
    proc_fault: Optional[str] = None       # test-only: "host:point" SIGKILLs
                                           # that host process at a protocol
                                           # point (host_proc --fault) during
                                           # multiprocess saves
    heartbeat_s: Optional[float] = None    # host processes publish liveness
                                           # keys (heartbeats/host_<h>.json)
                                           # at this period; the recovery
                                           # supervisor reads them
                                           # (docs/partial_recovery.md)
    commit_poll_s: float = 0.02            # phase-2 vote-poll interval
    commit_timeout_s: float = 120.0        # give up on a quorum that never
                                           # forms (a peer died pre-vote)
    failfast_grace_s: float = 10.0         # after a host process dies, how
                                           # long surviving hosts may still
                                           # finish phase 2 before SIGTERM


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


class PartialRecoveryError(ValueError):
    """A shard-only recovery (:meth:`CheckNRunManager.restore_part`) cannot
    proceed for this host/step — the shard chain is structurally or
    physically unrecoverable on its own. Callers (the recovery supervisor,
    ``Trainer.recover_host``) catch this and FALL BACK to a full
    :meth:`restore`.

    ``kind`` taxonomy:

    * ``not-sharded`` — the checkpoint has no shard layout at all (pass
      ``num_hosts=`` explicitly to range-read an unsharded chain anyway)
    * ``bad-host`` — host index outside the target ``num_hosts``
    * ``broken-chain`` — a chain manifest is unreadable/quarantined
    * ``missing-part`` — a chain step's part manifest is gone AND its
      chunk payload cannot be reconstructed from the global manifest
      (a benign retention-reclaimed part does NOT raise — see
      :meth:`CheckNRunManager.restore_part`)
    * ``corrupt-chunk`` — a shard chunk failed integrity verification
      or its blob is gone
    """

    def __init__(self, host: int, step: Optional[int], kind: str,
                 detail: str = "") -> None:
        self.host = host
        self.step = step
        self.kind = kind
        self.detail = detail
        super().__init__(
            f"partial recovery of host {host} at step {step} "
            f"unavailable ({kind}): {detail}")


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
        if self.config.num_hosts > 1:
            return self._write_sharded(snap, cum, unc, cancel)
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

    # ------------------------------------------------- sharded write (§3.4)
    def _write_sharded(self, snap: Snapshot, cum, unc,
                       cancel: threading.Event) -> SaveResult:
        """Per-host shard writers + coordinator-less two-phase commit. Each
        host (a thread here; its own OS process with ``multiprocess=True``)
        runs its own WritePipeline over its row-shard,
        votes with a part manifest, then polls the parts namespace — the
        LAST host to observe all votes merges and commits the global
        manifest itself (docs/sharded_writers.md). There is no coordinator
        rank."""
        from ..dist.shard_writer import HostShardWriter, run_host_writers

        t_start = time.monotonic()
        step = snap.step
        cfg = self.config
        decision = self.policy.decide(step)
        qcfg = self._quant_config()
        qcfg = qcfg.resolve() if qcfg is not None else None
        deadline = (time.monotonic() + cfg.write_deadline_s
                    if cfg.write_deadline_s else None)

        # Overwriting a committed step in place is unsafe under any crash
        # (hosts rewrite chunk blobs the live manifest references), so the
        # sharded path refuses it loudly instead of risking a torn
        # "committed" checkpoint. Checkpoint steps are monotone in every
        # supported flow.
        if self.store.exists(mf.manifest_key(step)):
            raise ValueError(
                f"step {step} already has a committed checkpoint; sharded "
                f"saves never overwrite committed steps")
        # Purge stale phase-1 votes from an earlier aborted attempt at this
        # step: a leftover part manifest could otherwise satisfy the quorum
        # for a host that dies during THIS attempt (same step/host/num_hosts
        # stamps, same chunk sizes) and launder attempt-mixed state into a
        # committed manifest. Votes are cheap to rewrite; stale chunk blobs
        # are harmless (each vote only references chunks its own attempt
        # durably wrote before voting).
        for key in self.store.list(mf.part_prefix(step)):
            self.store.delete(key)

        prev = mf.latest_step(self.store)  # before commit, like single-host
        base = (step if decision == "full" else self.policy.state.baseline_step)
        # The commit context is computed ONCE per attempt and shared by
        # every host, so all potential phase-2 committers build
        # byte-identical manifests (the idempotence invariant).
        ctx = CommitContext(
            kind=decision, base_step=base, prev_step=prev,
            quant=(dataclasses.asdict(qcfg) if qcfg else None),
            policy=self.policy.to_dict() | {"name": self.policy.name},
            extra=snap.extra | {"bitwidth": (self.bitwidth.to_dict()
                                             if self.bitwidth else None)})

        if cfg.multiprocess:
            return self._write_sharded_multiprocess(
                snap, cum, unc, cancel, decision, qcfg, ctx, t_start,
                deadline)

        writers = [HostShardWriter(h, cfg.num_hosts, self.store, self,
                                   cancel=cancel, deadline=deadline)
                   for h in range(cfg.num_hosts)]
        try:
            run_host_writers(writers, snap, decision, qcfg, cum, unc,
                             ctx=ctx,
                             verify_chunks=cfg.verify_shard_chunks,
                             commit_timeout_s=cfg.commit_timeout_s,
                             commit_poll_s=cfg.commit_poll_s)
        except mf.CommitRaceError:
            # the protocol-violation tripwire (divergent manifest bytes)
            # must NEVER be absorbed by the manifest-exists guard below —
            # a manifest existing is this error's precondition
            raise
        except Exception:
            if not self.store.exists(mf.manifest_key(step)):
                raise
            # a cancellation — or any host's transient phase-2 error —
            # raced the last voter's commit: the manifest is durable, so
            # the checkpoint IS valid. The store outranks the exception;
            # re-raising here would report a committed save as failed and
            # make the step permanently unsaveable (re-saves of committed
            # steps are refused). (Commit implies all N votes of THIS
            # attempt landed, so every writer's stats below are complete.)
        # on the success path the last voter wrote the manifest before its
        # poll returned, so loading it cannot miss
        man = mf.load(self.store, step)

        self._post_commit(step, decision, man.nbytes_total)
        per_host = [w.stats for w in writers]
        return SaveResult(
            step=step, kind=decision, nbytes=man.nbytes_total,
            # quantize_s is a subset of encode_busy_s (quant runs inside
            # the encode stage), so it is NOT added on top
            build_time_s=sum(s["encode_busy_s"] for s in per_host),
            write_time_s=sum(s["write_busy_s"] for s in per_host),
            pipeline_stats=dict(
                num_hosts=cfg.num_hosts,
                items=sum(s["items"] for s in per_host),
                payload_bytes=sum(s["payload_bytes"] for s in per_host),
                encode_busy_s=sum(s["encode_busy_s"] for s in per_host),
                write_busy_s=sum(s["write_busy_s"] for s in per_host),
                quantize_s=sum(s["quantize_s"] for s in per_host),
                wall_s=time.monotonic() - t_start,
                per_host=per_host))

    # ------------------------------------- multiprocess hosts (real OS procs)
    def _write_sharded_multiprocess(self, snap: Snapshot, cum, unc,
                                    cancel: threading.Event, decision: str,
                                    qcfg, ctx: CommitContext,
                                    t_start: float,
                                    deadline: Optional[float]
                                    ) -> SaveResult:
        """Spawn one OS process per host (``repro_torch.dist.host_proc``)
        over the shared LocalFSStore root (or remote store URI) and await
        the committed manifest. The
        STORE is the source of truth: the save succeeded iff the global
        manifest exists once every host process has exited — child exit
        codes only feed diagnostics (a SIGKILLed host does not un-commit a
        manifest its peers already wrote). ``write_deadline_s`` is enforced
        on both sides: each child's pipeline aborts at the deadline, and
        the parent SIGTERMs wedged children past it (backstop)."""
        import shutil
        import subprocess
        import tempfile

        from ..dist import host_proc

        cfg = self.config
        step = snap.step
        if isinstance(self.store, LocalFSStore):
            store_arg = self.store.root
        else:
            # multi-pod: hosts share no filesystem — they reach the store
            # by URI (http://host:port → RemoteObjectStore). Chunks, votes
            # and the phase-2 commit all run over remote keys.
            store_arg = getattr(self.store, "uri", None)
            if not store_arg or not store_arg.startswith("http://"):
                raise ValueError(
                    "multiprocess sharded saves need a LocalFSStore or a "
                    "remote store with a network-reachable URI; got "
                    f"{type(self.store).__name__} "
                    f"(uri={store_arg!r})")

        spill = tempfile.mkdtemp(prefix=f"cnr-spill-{step}-",
                                 dir=cfg.spill_dir)
        procs: List[Tuple[Any, Any]] = []
        spawned_unix: List[float] = []
        try:
            t_spill = time.monotonic()
            host_proc.write_spill(spill, snap, cum, unc, cfg, step,
                                  cfg.num_hosts, ctx,
                                  cfg.verify_shard_chunks)
            spill_s = time.monotonic() - t_spill
            spill_bytes = sum(e.stat().st_size for e in os.scandir(spill))
            env = host_proc.child_env()
            fault_host, fault_point = -1, None
            if cfg.proc_fault:
                fh, fault_point = cfg.proc_fault.split(":", 1)
                fault_host = int(fh)
            fence_epochs = [0] * cfg.num_hosts
            if cfg.heartbeat_s is not None:
                # replacement processes after a recovery must beat at the
                # CURRENT fence epoch — at the old epoch the heartbeat
                # writer would see itself fenced and exit(4) immediately
                from ..dist.recovery import read_fence
                fence_epochs = [read_fence(self.store, h)
                                for h in range(cfg.num_hosts)]
            for h in range(cfg.num_hosts):
                cmd = host_proc.host_command(
                    store_arg, spill, h,
                    fault=fault_point if h == fault_host else None,
                    heartbeat_s=cfg.heartbeat_s,
                    heartbeat_epoch=fence_epochs[h],
                    net_fault=cfg.remote_fault,
                    batch_fsync=cfg.batch_fsync,
                    poll_interval_s=cfg.commit_poll_s,
                    commit_timeout_s=cfg.commit_timeout_s,
                    # absolute epoch: the child's interpreter boot spends
                    # the deadline budget, it does not extend it
                    deadline_unix=(time.time()
                                   + (deadline - time.monotonic())
                                   if deadline is not None else None),
                    watch_parent=True)
                log = open(os.path.join(spill, f"host_{h:04d}.log"), "wb")
                try:
                    spawned_unix.append(time.time())
                    p = subprocess.Popen(cmd, env=env, stdout=log,
                                         stderr=subprocess.STDOUT)
                except BaseException:
                    log.close()
                    raise
                procs.append((p, log))
            codes, expired = self._await_host_procs(
                [p for p, _ in procs], cancel, step, deadline)
            # each process's kernel launches and timings: its counters live
            # in its own address space, so it leaves them in the spill
            per_host = [host_proc.load_host_stats(spill, h)
                        for h in range(cfg.num_hosts)]
            for st, t0 in zip(per_host, spawned_unix):
                if st is not None:
                    st["import_s"] = st["main_unix"] - t0
                    st["startup_s"] = st["ready_unix"] - t0
                    st["proc_wall_s"] = st["done_unix"] - t0

            if 5 in codes:
                # a host detected divergent manifest bytes
                # (CommitRaceError, exit 5): the determinism invariant
                # was violated — surface it even though a manifest
                # exists, never report success over it
                raise mf.CommitRaceError(
                    f"step {step}: a host process reported divergent "
                    f"manifest bytes (exit codes: {codes})")
            if not self.store.exists(mf.manifest_key(step)):
                if cancel.is_set() or expired:
                    raise CheckpointCancelled(
                        f"multiprocess save step {step}")
                err = host_proc.MultiprocessSaveError(
                    f"step {step}: no host committed the manifest "
                    f"(exit codes: {codes})")
                for h in range(len(procs)):
                    tail = self._read_log_tail(
                        os.path.join(spill, f"host_{h:04d}.log"))
                    if tail:
                        err.args = (err.args[0]
                                    + f"\n-- host {h} log tail --\n" + tail,)
                raise err
        except BaseException:
            # a mid-spawn failure (fork EAGAIN, unwritable log, ...) must
            # not leave already-launched hosts writing to the shared store
            # (no-op for hosts that already exited)
            self._terminate_procs([p for p, _ in procs])
            raise
        finally:
            for _, log in procs:
                log.close()
            # the spill is a full O(snapshot) copy — never strand it, on
            # any path (log tails are read above, before this runs)
            shutil.rmtree(spill, ignore_errors=True)

        man = mf.load(self.store, step)
        self._post_commit(step, decision, man.nbytes_total)
        return SaveResult(
            step=step, kind=decision, nbytes=man.nbytes_total,
            build_time_s=0.0, write_time_s=0.0,
            pipeline_stats=dict(num_hosts=cfg.num_hosts, multiprocess=True,
                                exit_codes=codes,
                                wall_s=time.monotonic() - t_start,
                                spill_s=spill_s, spill_bytes=spill_bytes,
                                per_host=per_host))

    @staticmethod
    def _read_log_tail(path: str, nbytes: int = 2048) -> str:
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - nbytes))
                return f.read().decode(errors="replace").strip()
        except OSError:
            return ""

    @staticmethod
    def _terminate_procs(procs) -> List[Optional[int]]:
        """SIGTERM every live host process and REAP it (SIGKILL escalation
        after 10 s, then a final wait so no zombie survives and exit codes
        are real, not None)."""
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10.0)
            except Exception:
                p.kill()
                try:
                    p.wait(timeout=10.0)
                except Exception:  # pragma: no cover - unkillable child
                    pass
        return [p.poll() for p in procs]

    def _await_host_procs(self, procs, cancel: threading.Event, step: int,
                          deadline: Optional[float]
                          ) -> Tuple[List[Optional[int]], bool]:
        """Await every host process; returns (exit codes, deadline
        expired). Fail-fast policy: once any host dies abnormally,
        surviving hosts get ``failfast_grace_s`` to finish phase 2 (if the
        victim died after voting, a peer commits within a poll interval),
        then are SIGTERMed — terminating a polling or mid-merge host is
        safe, the manifest put is atomic. A set ``cancel`` event terminates
        all hosts immediately (§3.3); ``deadline`` (+ grace, children
        enforce it themselves first) is the wedged-child backstop."""
        grace = self.config.failfast_grace_s
        grace_until = None
        commit_grace_until = None
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                return codes, False
            if cancel.is_set():
                return self._terminate_procs(procs), False
            if deadline is not None and time.monotonic() >= deadline + grace:
                return self._terminate_procs(procs), True
            committed = self.store.exists(mf.manifest_key(step))
            if committed:
                # checkpoint durable — healthy hosts observe the manifest
                # within a poll interval and exit; a host wedged past that
                # (stalled disk mid-fsync) must not hang save() forever
                if commit_grace_until is None:
                    commit_grace_until = time.monotonic() + grace
                elif time.monotonic() >= commit_grace_until:
                    return self._terminate_procs(procs), False
            failed = any(c not in (None, 0) for c in codes)
            if failed and not committed:
                if grace_until is None:
                    grace_until = time.monotonic() + grace
                elif time.monotonic() >= grace_until:
                    return self._terminate_procs(procs), False
            time.sleep(0.02)

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
        """Lazily range-read ONE host's row-shard of a checkpoint: only the
        chunks whose row bounds intersect the host's target ranges are
        fetched (plus the final step's dense params, which are global).
        Table arrays in the result cover just the host's row range;
        ``extra["shard"]`` records the ranges (everything the train-side
        splice — ``repro_torch.train.state.splice_shard_state`` — needs to
        overwrite the shard's rows of a live TrainState).

        Layout-independent (docs/resharding.md): the target layout is
        ``num_hosts`` when given — ANY positive count, regardless of how
        the chain was written — else the final manifest's recorded
        layout. The range planner (``core/range_reader``) resolves the
        minimal chunk set across the union of all source shards, so a
        chain written at N hosts partial-restores onto N±k hosts; chunks
        straddling a new shard boundary are clip-applied to the
        intersecting rows. ``extra["shard"]["resharded"]`` flags reads
        that crossed a layout change.

        Structurally or physically unrecoverable shards raise
        :class:`PartialRecoveryError` (typed, with a ``kind``); callers
        fall back to a full :meth:`restore`. A chain step whose part
        manifest was retention/GC-reclaimed but whose payload is intact
        (the benign ``reclaimed-part`` classification in
        ``core/integrity.py``) does NOT abort the replay — the global
        manifest's merged chunk records, whose keys retain the
        ``host_<h>/`` namespace, carry everything the planner needs.

        A reader-side operation: does NOT resync the manager's policy or
        touched-row bookkeeping (use :meth:`restore`, or the partial-
        recovery splice path in ``repro_torch.train.loop``, to resume
        training)."""
        store = self.store
        if step is None:
            step = mf.latest_step(store)
        if step is None:
            raise FileNotFoundError("no valid checkpoint found")
        t0 = time.monotonic()
        try:
            chain = mf.recovery_chain(store, step)
        except (KeyError, FileNotFoundError, ValueError) as e:
            raise PartialRecoveryError(
                host, step, "broken-chain",
                f"recovery chain unreadable: {e}") from e
        final = chain[-1]
        src_n = rr.layout_num_hosts(final)
        tgt = num_hosts
        if tgt is None:
            tgt = (final.shards or {}).get("num_hosts")
            if tgt is None:
                raise PartialRecoveryError(
                    host, step, "not-sharded",
                    f"checkpoint {step} is not sharded; use restore(), or "
                    f"pass num_hosts= to range-read it under a new layout")
        if not 0 <= host < tgt:
            raise PartialRecoveryError(
                host, step, "bad-host",
                f"host {host} out of range for {tgt} hosts")

        targets = rr.shard_targets(final.tables, host, tgt)
        try:
            plan = rr.plan_ranges(chain, targets, check_coverage=True)
        except rr.RangeCoverageError as e:
            raise PartialRecoveryError(
                host, step, "missing-part", str(e)) from e
        self._check_shard_witness(chain, targets, host, step)
        resharded = any(n != tgt for n in plan.source_layouts)

        tables: Dict[str, np.ndarray] = {}
        row_state: Dict[str, Dict[str, np.ndarray]] = {}
        ranges: Dict[str, List[int]] = {}

        def alloc(name: str, rec: mf.TableRecord):
            # shard-sized scratch: planned chunks are clip-applied to rows
            # in the target range, scattered at offset -lo — memory stays
            # O(shard), not O(table)
            lo, hi = targets.get(name, [0, rec.rows])
            ranges[name] = [lo, hi]
            return np.zeros((hi - lo, rec.dim), np.float32), lo

        dense: Dict[str, np.ndarray] = {}
        try:
            stats = self._replay_plan(plan, tables, row_state, dense, alloc)
        except ChunkCorruptionError as e:
            self._count(corruption_errors_total=1)
            raise PartialRecoveryError(
                host, step, "corrupt-chunk", str(e)) from e
        except (KeyError, FileNotFoundError) as e:
            # a chunk blob the manifest references is gone (GC race,
            # partial quarantine) — unrecoverable from this shard alone
            raise PartialRecoveryError(
                host, step, "corrupt-chunk",
                f"shard chunk blob unreadable: {e}") from e
        extra = dict(final.extra)
        extra["shard"] = {"host": host, "num_hosts": tgt,
                          "row_range": ranges, "resharded": resharded,
                          "source_num_hosts": src_n,
                          "source_layouts": [int(n)
                                             for n in plan.source_layouts]}
        rows_replayed = sum(pr.chunk.n_rows for pr in plan.reads)
        kind_count = (dict(recoveries_resharded_total=1) if resharded
                      else dict(recoveries_partial_total=1))
        self._count(restore_bytes_total=int(stats.get("payload_bytes", 0)),
                    recovery_rows_replayed_total=int(rows_replayed),
                    last_recovery_wall_s=time.monotonic() - t0,
                    last_recovery_host=host,
                    last_recovery_source_hosts=src_n,
                    last_recovery_target_hosts=int(tgt),
                    **kind_count)
        return RestoredState(step=final.step, tables=tables,
                             row_state=row_state, dense=dense, extra=extra,
                             chain_len=len(chain), stats=stats)

    def _check_shard_witness(self, chain: List[mf.Manifest],
                             targets: Dict[str, List[int]], host: int,
                             step: int) -> None:
        """Distinguish "this source host touched no rows" from "this source
        host's chunk records are LOST". The planner treats a sharded chain
        step with no chunks for some source host as a legitimately-empty
        increment — but when that host's writer shard intersects the
        target ranges, its durable part manifest is consulted as the
        tie-breaker: part gone too (nothing reconstructable) or part
        contradicting the global manifest ⇒ the shard data is gone ⇒
        typed ``missing-part``, exactly the refusal the pre-planner
        shard reader raised."""
        for man in chain:
            if not man.tables:
                continue
            src_n = rr.layout_num_hosts(man)
            if src_n <= 1:
                continue  # single-host chunks aren't host-namespaced
            needed = set()
            for name, rec in man.tables.items():
                tgt_rng = targets.get(name)
                if tgt_rng is None:
                    continue
                tlo, thi = tgt_rng
                bounds = rr.row_shard_bounds(rec.rows, src_n)
                for h, (lo, hi) in enumerate(bounds):
                    if lo < hi and lo < thi and tlo < hi:
                        needed.add(h)
            recorded = {rr.host_of_chunk_key(ch.key)
                        for rec in man.tables.values()
                        for ch in rec.chunks}
            for h in sorted(needed - recorded):
                try:
                    part = mf.load_part(self.store, man.step, h)
                except (KeyError, FileNotFoundError) as e:
                    raise PartialRecoveryError(
                        host, step, "missing-part",
                        f"chain step {man.step}: no chunks recorded for "
                        f"source host {h} and its part manifest is "
                        f"gone") from e
                if any(r.chunks for r in part.tables.values()):
                    raise PartialRecoveryError(
                        host, step, "missing-part",
                        f"chain step {man.step}: the global manifest "
                        f"records no chunks for source host {h} but its "
                        f"part manifest does — merged records damaged")

    def resync_from(self, step: int) -> None:
        """Resync the manager's incremental-policy and touched-row
        bookkeeping to a committed step WITHOUT fetching any payload —
        the partial-recovery exact path rolls survivors back from
        in-memory state and replays only the failed shard, so the
        payload-free half of :meth:`restore`'s resync needs to be callable
        on its own."""
        final = mf.load(self.store, step)
        self.policy.load_dict(final.policy)
        if self.bitwidth is not None and final.extra.get("bitwidth"):
            self.bitwidth.load_dict(final.extra["bitwidth"])
            self.bitwidth.on_restore()
        with self._lock:
            self._cum_touched = {}
            self._uncommitted = {}

    def refence_shard(self, ranges: Dict[str, List[int]]) -> None:
        """Re-fence the touched-row tracker for a recovered shard: the
        shard's rows now hold the last COMMITTED checkpoint's values, so
        any since-last-commit touched bits for them are stale claims —
        clear them (rows outside the shard keep their bits). The
        since-last-FULL mask is left alone: relative to an older full
        baseline the restored rows may still differ, and an incremental
        save that skipped them would lose data; re-storing an unchanged
        row is merely redundant."""
        with self._lock:
            for name, rng in ranges.items():
                lo, hi = rng
                m = self._uncommitted.get(name)
                if m is not None and hi <= len(m):
                    m[lo:hi] = False

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
