"""Remote object-store abstraction (Check-N-Run §3, "written to remote
object storage").

Backends:
  * ``LocalFSStore``   — durable, atomic (temp + rename) local filesystem.
  * ``InMemoryStore``  — for tests/benchmarks.
  * ``ThrottledStore`` — wraps any store with a bytes/sec write-bandwidth cap
                          to emulate the remote-storage bottleneck the paper
                          optimizes for.

Every store keeps exact write/read byte counters so the Fig. 8/9/11
benchmarks report measured bandwidth/capacity, not estimates.
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple


class StoreCounters:
    def __init__(self) -> None:
        self.bytes_written = 0
        self.bytes_read = 0
        self.put_ops = 0
        self.get_ops = 0
        self.delete_ops = 0
        self._lock = threading.Lock()

    def on_put(self, n: int) -> None:
        with self._lock:
            self.bytes_written += n
            self.put_ops += 1

    def on_get(self, n: int) -> None:
        with self._lock:
            self.bytes_read += n
            self.get_ops += 1

    def on_delete(self) -> None:
        with self._lock:
            self.delete_ops += 1

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(
                bytes_written=self.bytes_written,
                bytes_read=self.bytes_read,
                put_ops=self.put_ops,
                get_ops=self.get_ops,
                delete_ops=self.delete_ops,
            )


def run_parallel(fns, max_workers: int = 4, name_prefix: str = "par"):
    """Run thunks on a bounded pool; results in submission order. All
    in-flight work settles before the first exception (submission order)
    is re-raised — shared single-use fan-out for multi-key store ops and
    parallel restore."""
    if len(fns) <= 1 or max_workers <= 1:
        return [fn() for fn in fns]
    with ThreadPoolExecutor(min(max_workers, len(fns)),
                            thread_name_prefix=name_prefix) as pool:
        futs = [pool.submit(fn) for fn in fns]
        errs = [f.exception() for f in futs]
    for e in errs:
        if e is not None:
            raise e
    return [f.result() for f in futs]


class ObjectStore:
    """put/get/delete/list of immutable blobs under string keys."""

    def __init__(self) -> None:
        self.counters = StoreCounters()

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def list(self, prefix: str = "") -> Iterable[str]:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def size(self, key: str) -> int:
        raise NotImplementedError

    def total_bytes(self, prefix: str = "") -> int:
        return sum(self.size(k) for k in self.list(prefix))

    def move(self, src: str, dst: str) -> None:
        """Relocate one blob (``integrity.quarantine_step``'s workhorse).
        Copy-then-delete, so a crash mid-move leaves the blob readable at
        one key or both — never at neither. Backends with a native rename
        may override; LocalFSStore keeps this default because its keys map
        to paths across directories and the copy preserves the
        written-blob durability guarantees of ``put``."""
        self.put(dst, self.get(src))
        self.delete(src)

    # ------------------------------------------------------- multi-key ops
    def put_many(self, items: Sequence[Tuple[str, bytes]],
                 max_workers: int = 4) -> None:
        """Store several blobs concurrently. Atomicity stays per-key (the
        manifest commit provides checkpoint-level atomicity); a failed put
        raises after all in-flight puts settle."""
        run_parallel([lambda k=k, d=d: self.put(k, d) for k, d in items],
                     max_workers, "store-put")

    def get_many(self, keys: Sequence[str],
                 max_workers: int = 4) -> List[bytes]:
        """Fetch several blobs concurrently; results in ``keys`` order."""
        return run_parallel([lambda k=k: self.get(k) for k in keys],
                            max_workers, "store-get")

    @staticmethod
    def checksum(data: bytes) -> int:
        return zlib.crc32(data) & 0xFFFFFFFF


class InMemoryStore(ObjectStore):
    def __init__(self) -> None:
        super().__init__()
        self._blobs: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._blobs[key] = bytes(data)
        self.counters.on_put(len(data))

    def get(self, key: str) -> bytes:
        with self._lock:
            data = self._blobs[key]
        self.counters.on_get(len(data))
        return data

    def delete(self, key: str) -> None:
        with self._lock:
            self._blobs.pop(key, None)
        self.counters.on_delete()

    def list(self, prefix: str = "") -> Iterable[str]:
        with self._lock:
            return sorted(k for k in self._blobs if k.startswith(prefix))

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._blobs

    def size(self, key: str) -> int:
        with self._lock:
            return len(self._blobs[key])


def _fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so a rename/create inside it survives power loss.

    ``os.replace`` makes a write atomic but not durable: until the parent
    directory's entry is flushed, a crash can roll the rename back and the
    blob — a phase-1 vote, or the committed global manifest itself —
    silently vanishes. POSIX durability requires fsyncing the dirfd."""
    fd = os.open(path, getattr(os, "O_DIRECTORY", os.O_RDONLY))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class LocalFSStore(ObjectStore):
    """Atomic, durable local-FS store: writes go to ``<path>.tmp.<pid>``,
    fsync, rename, then fsync of the parent directory (and of any
    intermediate directories the put created) — safe for concurrent writers
    across processes (``os.replace`` is atomic; keys are immutable).

    ``batch_fsync=True`` defers the DIRECTORY fsyncs for bulk payload keys
    (chunk blobs): their parent-dir entries are collected in a dirty set
    and flushed in one pass by :meth:`flush_dirs` — which every put to a
    ``durable_prefixes`` namespace (votes, manifests) runs automatically
    BEFORE its own rename lands. The crash-safety point is unchanged — a
    durable vote/manifest still implies every chunk it references survives
    power loss — but an N-chunk save pays O(dirs) metadata flushes instead
    of O(chunks), the difference between milliseconds and minutes on
    HDD/NFS. File-data fsyncs are never deferred, only the dirent flush."""

    def __init__(self, root: str, batch_fsync: bool = False,
                 durable_prefixes: Tuple[str, ...] = ("parts/",
                                                      "manifests/")) -> None:
        super().__init__()
        self.root = root
        self.batch_fsync = batch_fsync
        self.durable_prefixes = durable_prefixes
        self._dirty_dirs: set = set()
        self._dirty_lock = threading.Lock()
        os.makedirs(root, exist_ok=True)

    def _contained(self, path: str) -> bool:
        root = os.path.normpath(self.root)
        return path == root or path.startswith(root + os.sep)

    def _path(self, key: str) -> str:
        path = os.path.normpath(os.path.join(self.root, key))
        if not self._contained(path):
            raise ValueError(f"key escapes store root: {key!r}")
        return path

    def _ensure_dir_durable(self, d: str, defer: bool = False) -> None:
        """mkdir -p with durability: every directory this call creates is
        fsynced, as is the deepest pre-existing ancestor (whose entry table
        gained the first new child). ``defer=True`` (batch mode) records
        them in the dirty set for :meth:`flush_dirs` instead."""
        created = []
        cur = d
        while cur and not os.path.isdir(cur):
            created.append(cur)
            parent = os.path.dirname(cur)
            if parent == cur:
                break
            cur = parent
        if not created:
            return
        os.makedirs(d, exist_ok=True)
        if defer:
            with self._dirty_lock:
                self._dirty_dirs.update(created)
                if os.path.isdir(cur):
                    self._dirty_dirs.add(cur)
            return
        for p in created:  # deepest-first is fine: contents, then entry
            _fsync_dir(p)
        if os.path.isdir(cur):
            _fsync_dir(cur)

    def flush_dirs(self) -> int:
        """Flush every deferred directory-entry fsync (batch_fsync mode).
        Idempotent; returns the number of directories synced. Runs
        automatically before any vote/manifest put, and explicitly at
        pipeline drain (pre-vote) by the write engines."""
        with self._dirty_lock:
            dirty, self._dirty_dirs = self._dirty_dirs, set()
        synced = 0
        # children before parents: a parent's entry for a new subdir must
        # not be durable while the subdir's own entries are not
        for d in sorted(dirty, key=len, reverse=True):
            if os.path.isdir(d):
                _fsync_dir(d)
                synced += 1
        return synced

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        parent = os.path.dirname(path)
        durable_now = (not self.batch_fsync
                       or key.startswith(self.durable_prefixes))
        self._ensure_dir_durable(parent, defer=not durable_now)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        if durable_now and self.batch_fsync:
            # ordering invariant: a vote/manifest must never be durable
            # ahead of the chunk blobs it references — flush the deferred
            # chunk dirents BEFORE this key's rename can land
            self.flush_dirs()
        os.replace(tmp, path)
        if durable_now:
            # durability point: flush the directory entry for the rename —
            # without this the committed blob can vanish on a host crash
            _fsync_dir(parent)
        else:
            with self._dirty_lock:
                self._dirty_dirs.add(parent)
        self.counters.on_put(len(data))

    def get(self, key: str) -> bytes:
        with open(self._path(key), "rb") as f:
            data = f.read()
        self.counters.on_get(len(data))
        return data

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass
        self.counters.on_delete()

    def list(self, prefix: str = "") -> Iterable[str]:
        # walk only the prefix's directory subtree — listing one step's
        # chunks must not scan every retained checkpoint's files
        base = self.root
        if "/" in prefix:
            subdir = prefix.rsplit("/", 1)[0]
            base = os.path.normpath(os.path.join(self.root, subdir))
            if not self._contained(base):
                raise ValueError(f"prefix escapes store root: {prefix!r}")
            if not os.path.isdir(base):
                return []
        out = []
        for dirpath, _, files in os.walk(base):
            for fn in files:
                if fn.endswith(".tmp") or ".tmp." in fn:
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def size(self, key: str) -> int:
        return os.path.getsize(self._path(key))

    def reclaim_tmp(self, older_than_s: float = 3600.0) -> int:
        """Delete stale ``*.tmp.<pid>.<tid>`` files — the half-written puts
        of writers that were SIGKILLed/terminated mid-write (a routine
        event under multiprocess fail-fast and orphan fencing).
        ``list()`` filters temp names, so the manifest-level GC can never
        see them; this is the only reclaim path. The age guard keeps live
        in-flight puts of concurrent writers safe (a put holds its temp
        file for seconds, not hours). Returns the number removed."""
        removed = 0
        now = time.time()
        for dirpath, _, files in os.walk(self.root):
            for fn in files:
                if ".tmp." not in fn and not fn.endswith(".tmp"):
                    continue
                path = os.path.join(dirpath, fn)
                try:
                    if now - os.path.getmtime(path) >= older_than_s:
                        os.remove(path)
                        removed += 1
                except OSError:  # pragma: no cover - raced another cleaner
                    pass
        return removed


def host_link(key: str) -> int:
    """Link selector for per-host link modelling: keys inside a host
    namespace (``.../host_<h>/...`` chunks, ``.../host_<h>.json`` parts) map
    to that host's link; everything else (manifests, single-host layouts)
    rides link 0."""
    i = key.find("host_")
    if i < 0:
        return 0
    digits = key[i + len("host_"):].split("/", 1)[0].split(".", 1)[0]
    return int(digits) if digits.isdigit() else 0


class LinkModel:
    """One direction of a modelled network: ``num_links`` independent
    bandwidth-capped timelines. ``transmit`` reserves a ``nbytes/bw`` slot
    on a link and sleeps it out (cancellable, refunding the unused
    reservation) — concurrent transfers on one link serialize, so N
    parallel writers never exceed the configured per-link bandwidth.

    Shared by :class:`ThrottledStore` (both directions) and the remote
    store's ``ThrottledTransport`` (``repro.core.remote_store``), so the
    throttled-store benchmark story and the remote-transport one use the
    same arithmetic."""

    def __init__(self, bytes_per_sec: float, num_links: int = 1,
                 cancel_event: Optional[threading.Event] = None) -> None:
        self.bw = float(bytes_per_sec)
        self.num_links = max(1, num_links)
        self.cancel_event = cancel_event or threading.Event()
        self._lock = threading.Lock()
        self._free_at = [0.0] * self.num_links

    def transmit(self, nbytes: int, link: int = 0, tag: str = "") -> None:
        delay = nbytes / self.bw
        link %= self.num_links
        with self._lock:
            start = max(time.monotonic(), self._free_at[link])
            end = start + delay
            self._free_at[link] = end
        try:
            # Sleep in slices so a cancel (straggler mitigation, §3.3)
            # interrupts mid-transmission.
            while True:
                remaining = end - time.monotonic()
                if remaining <= 0:
                    break
                if self.cancel_event.wait(timeout=min(remaining, 0.05)):
                    raise CheckpointCancelled(tag)
        except CheckpointCancelled:
            # Return our unused reservation so the next checkpoint does not
            # inherit a phantom backlog from cancelled transmissions. Each
            # transfer refunds only its own [start, end) slot, so concurrent
            # cancellations refund correctly in any order.
            with self._lock:
                unused = max(0.0, end - max(time.monotonic(), start))
                self._free_at[link] -= unused
            raise


class ThrottledStore(ObjectStore):
    """Caps link bandwidth (bytes/sec) to emulate remote-storage limits.

    By default concurrent ``put`` calls share ONE link: each reserves a
    transmission slot on a common timeline, so N parallel writers never
    exceed the configured aggregate bandwidth. This keeps the pipelined
    write engine honest — parallelism overlaps encoding with the link, it
    does not conjure extra bandwidth.

    The read direction models network-bound RECOVERY the same way:
    ``read_bytes_per_sec`` reserves slots on a separate per-link download
    timeline (links are full-duplex — reads never queue behind writes),
    and ``read_latency_s`` charges a fixed per-request first-byte latency
    (object-store GETs pay a round trip before data flows). Latencies of
    concurrent requests overlap; bandwidth is shared — so a serial
    chunk-by-chunk restore pays ``n × latency + bytes/bw`` while a
    pipelined one pays ``≈ max(latency, bytes/bw)`` past the first chunk,
    which is exactly the effect ``benchmarks/write_path.py --restore-only``
    measures. Both default off (reads cost nothing), matching the
    write-only modelling older benchmarks assume.

    With ``num_links > 1`` the store models per-host uplinks instead: a
    ``link_of(key)`` selector (e.g. :func:`host_link`) routes each
    transfer to one of ``num_links`` independent timelines, each capped at
    the configured bandwidth. Shared-aggregate vs per-host links is exactly
    the comparison ``benchmarks/write_path.py --num-hosts`` sweeps.
    """

    def __init__(self, inner: ObjectStore, write_bytes_per_sec: float,
                 cancel_event: Optional[threading.Event] = None,
                 num_links: int = 1,
                 link_of: Optional[Callable[[str], int]] = None,
                 read_bytes_per_sec: Optional[float] = None,
                 read_latency_s: float = 0.0) -> None:
        super().__init__()
        self.inner = inner
        self.bw = float(write_bytes_per_sec)
        self.read_bw = (float(read_bytes_per_sec)
                        if read_bytes_per_sec else None)
        self.read_latency = float(read_latency_s)
        self.cancel_event = cancel_event or threading.Event()
        self.counters = inner.counters
        self.num_links = max(1, num_links)
        self.link_of = link_of
        self._uplink = LinkModel(self.bw, self.num_links, self.cancel_event)
        self._downlink = (LinkModel(self.read_bw, self.num_links,
                                    self.cancel_event)
                          if self.read_bw is not None else None)

    def _link_index(self, key: str) -> int:
        if self.link_of is None or self.num_links == 1:
            return 0
        return self.link_of(key) % self.num_links

    def put(self, key: str, data: bytes) -> None:
        self._uplink.transmit(len(data), self._link_index(key), key)
        self.inner.put(key, data)

    def get(self, key: str) -> bytes:
        data = self.inner.get(key)
        if self.read_latency > 0:
            # per-request first-byte latency: overlaps across concurrent
            # requests (it is server/RTT time, not link occupancy)
            if self.cancel_event.wait(timeout=self.read_latency):
                raise CheckpointCancelled(key)
        if self._downlink is not None:
            self._downlink.transmit(len(data), self._link_index(key), key)
        return data

    def delete(self, key: str) -> None:
        self.inner.delete(key)

    def list(self, prefix: str = "") -> Iterable[str]:
        return self.inner.list(prefix)

    def exists(self, key: str) -> bool:
        return self.inner.exists(key)

    def size(self, key: str) -> int:
        return self.inner.size(key)


class CheckpointCancelled(RuntimeError):
    """Raised inside a writer when the in-flight checkpoint is cancelled."""
