"""Reader–trainer gap avoidance (Check-N-Run §3.1).

The distributed reader tier is told, at run start and after every checkpoint,
exactly how many batches to deliver before the next checkpoint. When the
trainer finishes that batch and triggers a checkpoint there are no in-flight
batches, so reader state (a batch cursor) and trainer state are exactly
aligned — no sample is trained twice or skipped after a restore.

``ReaderLease`` is the coordination object: the checkpoint manager issues a
lease for N batches; the reader refuses to deliver past the lease until the
manager (post-snapshot) renews it.
"""

from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass
class ReaderState:
    """Checkpointable cursor: which part of the dataset has been read."""

    next_batch: int = 0
    epoch: int = 0
    seed: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ReaderState":
        return cls(**d)


class ReaderLease:
    """Bounds how many batches the reader may run ahead of the trainer."""

    def __init__(self, interval_batches: int) -> None:
        self.interval = int(interval_batches)
        self._limit = self.interval
        self._cond = threading.Condition()
        self._closed = False

    @property
    def limit(self) -> int:
        with self._cond:
            return self._limit

    def acquire(self, batch_idx: int, timeout: float = 60.0) -> bool:
        """Reader calls this before producing ``batch_idx``; blocks at the
        lease boundary until the trainer checkpoints and renews."""
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._closed or batch_idx < self._limit, timeout=timeout)
            if self._closed:
                return False
            return ok

    def renew(self) -> int:
        """Checkpoint manager calls this after the snapshot is taken."""
        with self._cond:
            self._limit += self.interval
            self._cond.notify_all()
            return self._limit

    def set_limit(self, limit: int) -> None:
        with self._cond:
            self._limit = int(limit)
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
