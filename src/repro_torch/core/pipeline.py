"""Bounded multi-stage pipelines for checkpoint traffic (§3.4).

The paper's checkpoint creation is a pipeline, not a serial loop — and so
is recovery (FastPersist makes the same argument for the read side: both
directions must be pipelined to reach hardware limits). This module
provides one generic bounded stage executor and the two directional
engines built on it:

* :class:`StagePipeline` — N stages, each with its own worker pool; an
  item's value flows stage 0 → 1 → … → last. A bounded in-flight window (a
  semaphore held from submit until the final stage settles) caps resident
  payloads at O(window) no matter how many items a checkpoint produces.
  Optionally the FINAL stage applies items in submission order (a
  reordering buffer + a single worker), which is what lets a restore
  decode chunks concurrently and out of order while chain replay still
  overwrites rows in manifest order.
* :class:`WritePipeline` — encode → write (the save path; unchanged API).
* :class:`RestorePipeline` — fetch → decode → apply(ordered) (the restore
  path: store gets overlap dequantization, which overlaps the ordered
  scatter into the result arrays).

Shared semantics:

* Per-item futures settle in submission order on :meth:`drain`, so
  manifest chunk order (and replay order) is deterministic.
* Cancellation points before each stage: a set cancel event (or expired
  deadline) aborts promptly with :class:`CheckpointCancelled`; the caller
  never commits a manifest for an aborted pipeline.
* A crash in any worker is recorded, unblocks all waiters (no hang — a
  failed item also advances the ordered-apply sequence), and resurfaces as
  that item's Future exception and from :meth:`drain`.

Per-stage busy-time accounting feeds the occupancy metrics in
``benchmarks/write_path.py``.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .storage import CheckpointCancelled


class PipelineStats:
    """Per-stage busy seconds + item/byte counters for one pipeline run."""

    def __init__(self, stage_names: Sequence[str]) -> None:
        self.items = 0
        self.payload_bytes = 0
        self.wall_s = 0.0
        self.busy: Dict[str, float] = {n: 0.0 for n in stage_names}

    # Legacy accessors (the write path predates the generic executor).
    @property
    def encode_busy_s(self) -> float:
        return self.busy.get("encode", 0.0)

    @property
    def write_busy_s(self) -> float:
        return self.busy.get("write", 0.0)

    def occupancy(self, workers: Dict[str, int]) -> Dict[str, float]:
        wall = max(self.wall_s, 1e-9)
        return {n: self.busy.get(n, 0.0) / (wall * max(workers.get(n, 1), 1))
                for n in self.busy}


class _Item:
    __slots__ = ("seq", "fns", "value", "future")

    def __init__(self, seq: int, fns: Sequence[Callable]):
        self.seq = seq
        self.fns = fns
        self.value: Any = None
        self.future: Future = Future()


class StagePipeline:
    """Bounded chain-of-stages executor. One instance per transfer."""

    def __init__(self, stages: Sequence[Tuple[str, int]],
                 max_inflight: Optional[int] = None,
                 cancel: Optional[threading.Event] = None,
                 deadline: Optional[float] = None,
                 ordered_final: bool = False,
                 name_prefix: str = "cnr") -> None:
        assert stages, "need at least one stage"
        self.stage_names = [n for n, _ in stages]
        self.workers = {n: max(1, w) for n, w in stages}
        if ordered_final:
            # ordering relies on the final pool executing in submission
            # order, which requires exactly one worker
            self.workers[self.stage_names[-1]] = 1
        total_workers = sum(self.workers.values())
        self.max_inflight = max(1, max_inflight if max_inflight is not None
                                else total_workers + 4)
        self.cancel = cancel or threading.Event()
        self.deadline = deadline
        self.ordered_final = ordered_final
        self.stats = PipelineStats(self.stage_names)
        self._pools = [
            ThreadPoolExecutor(self.workers[n],
                               thread_name_prefix=f"{name_prefix}-{n}")
            for n in self.stage_names]
        self._sem = threading.Semaphore(self.max_inflight)
        self._lock = threading.Lock()
        self._first_error: Optional[BaseException] = None
        self._items: List[_Item] = []
        self._seq = 0
        # ordered-final reordering buffer: seq -> item | None (tombstone for
        # items that failed before reaching the final stage)
        self._ready: Dict[int, Optional[_Item]] = {}
        self._next_ord = 0
        self._t0 = time.monotonic()

    # ------------------------------------------------------------- aborting
    def _record_error(self, exc: BaseException) -> None:
        with self._lock:
            if self._first_error is None:
                self._first_error = exc

    def _check_abort(self) -> None:
        """Raise if the pipeline should stop feeding work. The root error is
        re-raised as itself so a worker crash is never misreported as a
        cancellation by callers that catch CheckpointCancelled."""
        with self._lock:
            err = self._first_error
        if err is not None:
            raise err
        if self.cancel.is_set():
            raise CheckpointCancelled("cancelled")
        if self.deadline is not None and time.monotonic() > self.deadline:
            raise CheckpointCancelled("deadline exceeded")

    # ------------------------------------------------------------ submission
    def submit(self, fns: Sequence[Callable]) -> Future:
        """Queue one item. ``fns[0]()`` runs on stage 0; each later
        ``fns[k](value)`` consumes the previous stage's return value; the
        Future resolves to the final stage's return value."""
        assert len(fns) == len(self.stage_names)
        # Bounded window; poll so cancellation/failure interrupts the wait.
        while not self._sem.acquire(timeout=0.05):
            self._check_abort()
        try:
            self._check_abort()
            item = _Item(self._seq, list(fns))
            self._seq += 1
            self._items.append(item)
            self._pools[0].submit(self._run_stage, item, 0)
            return item.future
        except BaseException:
            self._sem.release()
            raise

    def _settle(self, item: _Item, exc: BaseException) -> None:
        item.value = None
        self._sem.release()
        self._record_error(exc)
        item.future.set_exception(exc)

    def _settle_ok(self, item: _Item, result: Any) -> None:
        item.value = None
        self._sem.release()
        item.future.set_result(result)

    def _run_stage(self, item: _Item, k: int) -> None:
        last = len(self.stage_names) - 1
        try:
            self._check_abort()
            t0 = time.monotonic()
            value = item.fns[k]() if k == 0 else item.fns[k](item.value)
            dt = time.monotonic() - t0
            with self._lock:
                self.stats.busy[self.stage_names[k]] += dt
                if k == last:
                    self.stats.items += 1
        except BaseException as e:
            self._settle(item, e)
            if self.ordered_final and k < last:
                self._advance_ordered(item.seq, None)
            return
        if k == last:
            self._settle_ok(item, value)
            return
        item.value = value
        try:
            if self.ordered_final and k == last - 1:
                self._advance_ordered(item.seq, item)
            else:
                self._pools[k + 1].submit(self._run_stage, item, k + 1)
        except BaseException as e:  # executor torn down
            self._settle(item, e)

    def _advance_ordered(self, seq: int, item: Optional[_Item]) -> None:
        """Release ready items to the (single-worker) final stage strictly in
        submission order. ``item=None`` tombstones a failed seq so later
        items are never stranded behind it.

        The pool submissions happen WHILE HOLDING the lock: two workers
        finishing back-to-back may both find items runnable, and submitting
        after release would let the later caller enqueue its (higher-seq)
        items into the FIFO apply pool first — exactly the reorder the
        ordered stage exists to prevent. Failed submissions (executor torn
        down) settle after release because _settle re-takes the lock."""
        last = len(self.stage_names) - 1
        failed: List[Tuple[_Item, BaseException]] = []
        with self._lock:
            self._ready[seq] = item
            while self._next_ord in self._ready:
                nxt = self._ready.pop(self._next_ord)
                self._next_ord += 1
                if nxt is None:
                    continue
                try:
                    self._pools[last].submit(self._run_stage, nxt, last)
                except BaseException as e:  # executor torn down
                    failed.append((nxt, e))
        for it, e in failed:
            self._settle(it, e)

    # --------------------------------------------------------------- results
    def drain(self) -> List[Any]:
        """Block until every submitted item settles; return results in
        submission order, or raise the first error (by submission order)."""
        results = []
        first_exc: Optional[BaseException] = None
        for item in self._items:
            try:
                results.append(item.future.result())
            except BaseException as e:
                if first_exc is None:
                    first_exc = e
        self.stats.wall_s = time.monotonic() - self._t0
        if first_exc is not None:
            # Prefer the first error recorded in time: abort-cascade items
            # settle with a derived CheckpointCancelled, but the root cause
            # (a worker crash, a genuine cancel) was recorded first.
            with self._lock:
                root = self._first_error
            raise root if root is not None else first_exc
        return results

    def occupancy(self) -> Dict[str, float]:
        return self.stats.occupancy(self.workers)

    def close(self) -> None:
        for pool in self._pools:
            pool.shutdown(wait=True)
        if self.stats.wall_s == 0.0:
            self.stats.wall_s = time.monotonic() - self._t0

    def __enter__(self) -> "StagePipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class WritePipeline(StagePipeline):
    """encode → write executor for the save path. One instance per
    checkpoint write. ``submit(encode_fn, write_fn)``: ``encode_fn() ->
    (payload, result)`` runs on an encode worker; ``write_fn(payload)`` on
    a write worker; the Future resolves to ``result`` once the payload is
    durably put."""

    def __init__(self, encode_workers: int = 2, write_workers: int = 4,
                 max_inflight: Optional[int] = None,
                 cancel: Optional[threading.Event] = None,
                 deadline: Optional[float] = None) -> None:
        super().__init__([("encode", encode_workers),
                          ("write", write_workers)],
                         max_inflight=max_inflight, cancel=cancel,
                         deadline=deadline)

    @property
    def encode_workers(self) -> int:
        return self.workers["encode"]

    @property
    def write_workers(self) -> int:
        return self.workers["write"]

    def submit(self, encode_fn: Callable[[], Tuple[bytes, Any]],
               write_fn: Callable[[bytes], None]) -> Future:
        def enc():
            payload, result = encode_fn()
            with self._lock:
                self.stats.payload_bytes += len(payload)
            return payload, result

        def wr(value):
            payload, result = value
            write_fn(payload)
            return result

        return super().submit([enc, wr])


class RestorePipeline(StagePipeline):
    """fetch → decode → apply executor for the restore path. Fetches and
    decodes run concurrently and out of order; apply is serialized in
    submission (= chain replay) order so a later manifest's rows always
    overwrite an earlier one's. ``submit(fetch_fn, decode_fn, apply_fn)``:
    ``fetch_fn() -> bytes``, ``decode_fn(bytes) -> decoded``,
    ``apply_fn(decoded) -> result``."""

    def __init__(self, fetch_workers: int = 4, decode_workers: int = 2,
                 max_inflight: Optional[int] = None,
                 cancel: Optional[threading.Event] = None,
                 deadline: Optional[float] = None) -> None:
        super().__init__([("fetch", fetch_workers),
                          ("decode", decode_workers),
                          ("apply", 1)],
                         max_inflight=max_inflight, cancel=cancel,
                         deadline=deadline, ordered_final=True,
                         name_prefix="cnr-restore")

    @property
    def fetch_workers(self) -> int:
        return self.workers["fetch"]

    @property
    def decode_workers(self) -> int:
        return self.workers["decode"]

    def submit(self, fetch_fn: Callable[[], bytes],
               decode_fn: Callable[[bytes], Any],
               apply_fn: Callable[[Any], Any]) -> Future:
        def fetch():
            data = fetch_fn()
            with self._lock:
                self.stats.payload_bytes += len(data)
            return data

        return super().submit([fetch, decode_fn, apply_fn])
