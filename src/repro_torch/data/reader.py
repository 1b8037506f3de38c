"""The distributed-reader tier (paper §2.2/§3.1), scaled to one process.

A background producer thread fills a bounded queue with batches — the
"hundreds of reader nodes in charge of saturating the trainer". The reader
honors a :class:`~repro.core.reader_protocol.ReaderLease`: it will not read
past the lease boundary, so when the trainer finishes the lease's last batch
there are **zero in-flight batches** and reader state == trainer state —
Check-N-Run's gap-avoidance protocol.

Reader state (the batch cursor) is checkpointed with the model and restored
exactly; batches are pure functions of ``(seed, batch_idx)`` so the replayed
stream is identical.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Optional

import numpy as np

from ..core.reader_protocol import ReaderLease, ReaderState

BatchFn = Callable[[int], Dict[str, np.ndarray]]


class DataReader:
    def __init__(
        self,
        batch_fn: BatchFn,
        lease: Optional[ReaderLease] = None,
        prefetch: int = 4,
        state: Optional[ReaderState] = None,
        seed: int = 0,
    ) -> None:
        self.batch_fn = batch_fn
        self.lease = lease
        self.state = state or ReaderState(seed=seed)
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._cursor_lock = threading.Lock()
        self._produced = self.state.next_batch  # next batch idx to produce
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="reader-tier")
        self._thread.start()

    # -- producer ----------------------------------------------------------
    def _produce(self) -> None:
        while not self._stop.is_set():
            idx = self._produced
            if self.lease is not None and not self.lease.acquire(idx, timeout=0.2):
                if self._stop.is_set():
                    return
                continue
            batch = self.batch_fn(idx)
            while not self._stop.is_set():
                try:
                    self._queue.put((idx, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue
            self._produced = idx + 1

    # -- consumer ----------------------------------------------------------
    def next(self, timeout: float = 120.0) -> Dict[str, np.ndarray]:
        idx, batch = self._queue.get(timeout=timeout)
        with self._cursor_lock:
            assert idx == self.state.next_batch, (
                f"reader/trainer desync: got {idx}, expected {self.state.next_batch}")
            self.state.next_batch = idx + 1
        return batch

    def in_flight(self) -> int:
        """Batches read but not yet consumed — must be 0 at checkpoint time
        when the lease protocol is followed."""
        with self._cursor_lock:
            return self._produced - self.state.next_batch

    def checkpoint_state(self) -> ReaderState:
        with self._cursor_lock:
            return ReaderState(next_batch=self.state.next_batch,
                               epoch=self.state.epoch, seed=self.state.seed)

    def close(self) -> None:
        self._stop.set()
        if self.lease is not None:
            self.lease.close()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
