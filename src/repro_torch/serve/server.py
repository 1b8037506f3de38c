"""In-memory embedding server with a double-buffered row-block swap.

The serving replica holds two full copies of every embedding table: the
**front** buffers, read by concurrent ``lookup()`` calls, and the
**back** buffers, mutated by the single subscriber thread. Applying a
step scatters decoded chunk rows into the back buffers, then ``publish``
swaps front and back under the lock — an O(pointers) flip, so readers
never wait on row copies and never observe a partially applied step.

Version pinning makes multi-table reads consistent: ``pinned()`` yields a
:class:`PinnedView` that captures the published (version, step, buffers)
tuple and holds a refcount on that version. The writer's next
``begin_apply()`` blocks until every pin on superseded versions drains,
because the buffers those readers hold ARE the back buffers it is about
to overwrite. Plain ``lookup()`` is a one-table pinned read.

After a swap the new back buffer is one step behind the new front on
exactly the rows the published step touched; ``begin_apply`` repairs them
front→back over the recorded dirty spans (superset envelopes from the
delta index) before handing the buffer to the writer. An aborted apply
(`abort`) just widens that pending repair set — the front was never
touched, so readers keep serving the last good version untorn.

Dense (non-embedding) parameters are small and replaced wholesale: each
publish installs a fresh dict, pinned views capture the dict reference.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np

Spans = Dict[str, List[List[int]]]


class PinnedView:
    """A consistent read snapshot: every lookup through one view sees the
    same published version, even while the subscriber keeps applying new
    steps. Use as a context manager (``with server.pinned() as v:``) or
    call :meth:`release` explicitly; reading after release is a bug (the
    writer may be overwriting the buffers)."""

    def __init__(self, server: "EmbeddingServer", version: int,
                 step: Optional[int], tables: Dict[str, np.ndarray],
                 dense: Dict[str, np.ndarray]):
        self._server = server
        self.version = version
        self.step = step
        self._tables = tables
        self._dense = dense
        self._released = False

    def lookup(self, table: str, idx) -> np.ndarray:
        return self._tables[table][np.asarray(idx)]

    def dense(self, name: str) -> np.ndarray:
        return self._dense[name]

    def tables(self) -> Dict[str, np.ndarray]:
        return self._tables

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._server._unpin(self.version)

    def __enter__(self) -> "PinnedView":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class EmbeddingServer:
    """Double-buffered serving tables; see module docstring. Thread-safe
    for many readers + ONE writer (the subscriber)."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._front: Dict[str, np.ndarray] = {}
        self._back: Dict[str, np.ndarray] = {}
        self._dense: Dict[str, np.ndarray] = {}
        self._step: Optional[int] = None
        self._version = 0
        self._pins: Dict[int, int] = {}  # version -> active reader count
        # rows the back buffer is stale on (union of published-but-not-yet
        # -resynced dirty spans plus any aborted apply's touched envelope)
        self._pending: Spans = {}
        # counters (reader side; the subscriber owns refresh counters)
        self.lookups_total = 0
        self.rows_read_total = 0
        self.last_publish_unix: Optional[float] = None

    # ------------------------------------------------------------ readers
    @property
    def step(self) -> Optional[int]:
        with self._cond:
            return self._step

    @property
    def version(self) -> int:
        with self._cond:
            return self._version

    def table_names(self) -> List[str]:
        with self._cond:
            return sorted(self._front)

    def pinned(self) -> PinnedView:
        with self._cond:
            self._pins[self._version] = self._pins.get(self._version, 0) + 1
            self.lookups_total += 1
            return PinnedView(self, self._version, self._step,
                              self._front, self._dense)

    def lookup(self, table: str, idx) -> np.ndarray:
        """One-batch read: rows come from exactly one published version
        (copied out, so the result stays valid after the pin drops)."""
        with self.pinned() as v:
            out = np.array(v.lookup(table, idx))
            with self._cond:
                self.rows_read_total += len(out)
            return out

    def _unpin(self, version: int) -> None:
        with self._cond:
            n = self._pins.get(version, 0) - 1
            if n <= 0:
                self._pins.pop(version, None)
            else:
                self._pins[version] = n
            self._cond.notify_all()

    # ------------------------------------------------------------- writer
    def install(self, tables: Dict[str, np.ndarray],
                dense: Dict[str, np.ndarray], step: int) -> None:
        """Full sync: replace both buffers with fresh arrays. Readers
        pinned on older versions keep their captured arrays (which are
        never mutated again — they are simply dropped), so no drain is
        needed; the swap is atomic under the lock."""
        front = {k: np.ascontiguousarray(v) for k, v in tables.items()}
        back = {k: v.copy() for k, v in front.items()}
        with self._cond:
            self._front, self._back = front, back
            self._dense = dict(dense)
            self._step = step
            self._version += 1
            self._pending = {}
            self.last_publish_unix = time.time()
            self._cond.notify_all()

    def begin_apply(self, timeout: Optional[float] = None
                    ) -> Dict[str, np.ndarray]:
        """Hand the back buffers to the writer: wait until no reader pins
        a superseded version (their arrays are the back buffers), then
        repair pending stale rows front→back. Returns the back dict for
        in-place scatter; follow with :meth:`publish` or :meth:`abort`."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while any(v < self._version and n > 0
                      for v, n in self._pins.items()):
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            "readers still pin a superseded version")
                self._cond.wait(remaining)
            pending, self._pending = self._pending, {}
            front, back = self._front, self._back
        for name, spans in pending.items():
            src, dst = front.get(name), back.get(name)
            if src is None or dst is None:
                continue
            for lo, hi in spans:
                dst[lo:hi] = src[lo:hi]
        return back

    def publish(self, step: int, dirty: Spans,
                dense: Dict[str, np.ndarray]) -> None:
        """Swap the applied back buffer to the front. ``dirty`` is the
        superset of rows the apply touched (delta-index envelope); the now
        -stale other buffer is repaired lazily by the next begin_apply."""
        with self._cond:
            self._front, self._back = self._back, self._front
            self._dense = dict(dense)
            self._step = step
            self._version += 1
            self._merge_pending(dirty)
            self.last_publish_unix = time.time()
            self._cond.notify_all()

    def abort(self, dirty: Spans) -> None:
        """An apply died mid-scatter: the back buffer is torn on at most
        ``dirty``. The front was never touched — readers are safe — so
        recovery is just scheduling those rows for front→back repair."""
        with self._cond:
            self._merge_pending(dirty)

    def _merge_pending(self, dirty: Spans) -> None:
        # lazy import keeps this module importable standalone
        from .delta_index import merge_spans
        for name, spans in dirty.items():
            have = self._pending.get(name, [])
            self._pending[name] = merge_spans(list(have) + list(spans))

    # ------------------------------------------------------------ metrics
    def metrics(self) -> dict:
        with self._cond:
            return {
                "step": self._step,
                "version": self._version,
                "tables": len(self._front),
                "lookups_total": self.lookups_total,
                "rows_read_total": self.rows_read_total,
                "last_publish_unix": self.last_publish_unix,
            }
