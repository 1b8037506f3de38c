"""CheckpointSubscriber: follow a training job's manifest chain and keep
an :class:`~repro_torch.serve.server.EmbeddingServer` fresh by applying deltas.

Carried over from the reference (``src/repro/serve/subscriber.py``) with
its imports re-pointed. It is store-agnostic: local, in-memory and remote
(``make_store("http://…")``) stores alike.

State machine (docs/serving.md):

    init ──full sync──▶ live ◀──apply suffix── live
      │                  │  ╲
      │                  │   ──corruption──▶ held (serve last good,
      │                  │                   retry each poll)
      └──no steps──▶ idle└──transient──▶ retrying (backoff = poll cadence)

Each ``poll_once``:

1. list committed steps (one store ``list`` op — the only store traffic
   in steady state; manifests come from the validated cache),
2. if the head moved, build its recovery chain and derive the minimal
   suffix to replay over the applied step (missed steps collapse into the
   one plan; a full-checkpoint boundary inside the suffix just replays as
   a chunk set that covers every row),
3. stream fetch→decode→apply through a :class:`RestorePipeline` into the
   server's back buffers, then publish.

Incremental apply is used iff it is provably byte-identical to a cold
restore: the applied step must be ON the head's chain, or share the
chain's full baseline (cumulative-increment policies drop intermediate
steps from the chain, but a later increment covers every row touched
since that baseline — the chain's own correctness guarantees it).
Anything else — never synced, resized tables, GC'd lineage — falls back
to a full resync. A head whose chain no longer loads (GC'd or corrupt
intermediates) is skipped in favor of the newest older step that still
chains, mirroring ``restore()``'s fallback walk.

Corruption (:class:`ChunkCorruptionError`) aborts the half-applied back
buffer (the front — what readers see — was never touched), pins the
subscriber in ``held`` with the offending step/key, and retries on later
polls: a GC or ``ckpt quarantine`` upstream unblocks it.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core import checkpoint as cp
from ..core import manifest as mf
from ..core import range_reader as rr
from ..core.integrity import ChunkCorruptionError
from ..core.pipeline import RestorePipeline

from .delta_index import touched_union
from .server import EmbeddingServer

_MISSING = (KeyError, FileNotFoundError)


class ManifestCache:
    """Validated per-step manifest cache (the PR's ``recovery_chain``
    bugfix): committed manifests are immutable, but a cache keyed on step
    alone would serve a stale entry if a step were quarantined and later
    rewritten, so every hit revalidates against the store's cheap
    ``size()`` stat (the etag analogue — LocalFS stat / remote HEAD, not
    a counted ``get``). Steady-state chain walks therefore cost zero
    ``get`` ops; each newly committed step costs exactly one."""

    def __init__(self, store, cap: int = 128):
        self.store = store
        self.cap = cap
        self._entries: Dict[int, tuple] = {}  # step -> (size, Manifest)
        self.hits = 0
        self.misses = 0

    def load(self, step: int) -> mf.Manifest:
        size = self.store.size(mf.manifest_key(step))  # raises if missing
        ent = self._entries.get(step)
        if ent is not None and ent[0] == size:
            self.hits += 1
            return ent[1]
        self.misses += 1
        raw = self.store.get(mf.manifest_key(step))
        man = mf.Manifest.from_json(raw.decode())
        self._entries[step] = (len(raw), man)
        while len(self._entries) > self.cap:
            self._entries.pop(min(self._entries))
        return man

    def chain(self, step: int) -> List[mf.Manifest]:
        return mf.recovery_chain(self.store, step, load_fn=self.load)

    def evict(self, step: int) -> None:
        self._entries.pop(step, None)


@dataclasses.dataclass
class SubscriberHealth:
    """Typed health surface — what a load balancer or operator polls.
    ``held`` means the replica is intentionally stale: it serves the last
    good version rather than a torn table (docs/serving.md runbook)."""

    state: str = "init"  # init | idle | live | held | retrying
    applied_step: Optional[int] = None
    head_step: Optional[int] = None
    lag_steps: int = 0
    reason: Optional[str] = None
    consecutive_failures: int = 0
    held_since_unix: Optional[float] = None

    @property
    def serving(self) -> bool:
        return self.applied_step is not None


class CheckpointSubscriber:
    """Poll a checkpoint namespace and stream deltas into a server."""

    def __init__(self, store, server: Optional[EmbeddingServer] = None,
                 fetch_workers: int = 4, decode_workers: int = 2,
                 max_inflight: int = 16):
        self.store = store
        self.server = server if server is not None else EmbeddingServer()
        self.cache = ManifestCache(store)
        self.health = SubscriberHealth()
        self.applied_step: Optional[int] = None
        self.applied_base: Optional[int] = None  # chain[0].step at last sync
        self._fetch_workers = fetch_workers
        self._decode_workers = decode_workers
        self._max_inflight = max_inflight
        # counters (surface as the "serve" section of render_prometheus)
        self.polls_total = 0
        self.applied_steps_total = 0
        self.refresh_bytes_total = 0
        self.refresh_rows_total = 0
        self.full_syncs_total = 0
        self.incremental_refreshes_total = 0
        self.holds_total = 0
        self.errors_total = 0
        self.last_refresh_wall_s: Optional[float] = None

    # ------------------------------------------------------------- polling
    def poll_once(self) -> bool:
        """One poll: returns True iff a new step was applied. Never raises
        on store/chain/decode failures — they land in :attr:`health`."""
        self.polls_total += 1
        try:
            steps = mf.list_steps(self.store)
        except Exception as e:  # noqa: BLE001 - transport errors vary by store
            self._transient(f"list failed: {e}")
            return False
        if not steps:
            if self.applied_step is None:
                self.health.state = "idle"
            return False
        self.health.head_step = steps[-1]
        if self.applied_step is not None and steps[-1] <= self.applied_step:
            self._ok(steps)
            return False
        chain = self._usable_chain(steps)
        if chain is None:
            return False
        target = chain[-1].step
        if self.applied_step is not None and target <= self.applied_step:
            self._ok(steps)  # head unrecoverable, nothing newer to apply
            return False
        t0 = time.monotonic()
        try:
            if self._can_apply_incrementally(chain):
                suffix = [m for m in chain if m.step > self.applied_step]
                if self._apply_suffix(suffix):
                    self.incremental_refreshes_total += 1
                else:
                    self.full_syncs_total += 1
            else:
                self._full_sync(chain)
                self.full_syncs_total += 1
        except ChunkCorruptionError as e:
            self.holds_total += 1
            self.health.state = "held"
            self.health.reason = str(e)
            self.health.consecutive_failures += 1
            if self.health.held_since_unix is None:
                self.health.held_since_unix = time.time()
            return False
        except Exception as e:  # noqa: BLE001 - fault-injected transports
            self._transient(f"refresh failed: {e}")
            return False
        self.last_refresh_wall_s = time.monotonic() - t0
        self.applied_step = target
        self.applied_base = chain[0].step
        self.applied_steps_total += 1
        self._ok(steps)
        return True

    def follow(self, poll_s: float = 1.0, max_polls: Optional[int] = None,
               stop: Optional[Callable[[], bool]] = None,
               on_apply: Optional[Callable[[int], None]] = None) -> int:
        """Poll until ``max_polls`` (None = forever) or ``stop()`` is
        truthy; returns the number of applied refreshes."""
        applied = 0
        polls = 0
        while max_polls is None or polls < max_polls:
            polls += 1
            if self.poll_once():
                applied += 1
                if on_apply is not None:
                    on_apply(self.applied_step)
            if stop is not None and stop():
                break
            if max_polls is None or polls < max_polls:
                time.sleep(poll_s)
        return applied

    # ------------------------------------------------------------ planning
    def _usable_chain(self, steps: List[int]) -> Optional[List[mf.Manifest]]:
        """Newest step whose recovery chain still fully loads — GC'd or
        corrupt intermediates poison a head, so walk older heads like
        ``restore()``'s fallback does. Quarantined steps vanish from
        ``list_steps`` upstream, so they are skipped for free."""
        for step in reversed(steps):
            if self.applied_step is not None and step <= self.applied_step:
                break
            try:
                return self.cache.chain(step)
            except _MISSING + (ValueError,) as e:
                self._transient(f"chain for step {step} unusable: {e}")
            except Exception as e:  # noqa: BLE001 - transport faults mid-walk
                # transient store error, not a broken chain: don't walk to
                # an older head (we'd regress freshness), retry next poll
                self._transient(f"chain for step {step} failed: {e}")
                return None
        return None

    def _can_apply_incrementally(self, chain: List[mf.Manifest]) -> bool:
        """Incremental apply is byte-identical to a cold restore only when
        replaying the chain's suffix over the applied state reproduces the
        full replay (module docstring); otherwise full-sync."""
        if self.applied_step is None:
            return False
        if any(m.step == self.applied_step for m in chain):
            return True
        # cumulative-increment chains omit intermediate steps; sharing the
        # full baseline is sufficient (a later increment covers every row
        # touched since the baseline, including everything we applied)
        return self.applied_base is not None \
            and chain[0].step == self.applied_base \
            and chain[0].step < self.applied_step

    # ------------------------------------------------------------ applying
    def _pipe(self) -> RestorePipeline:
        return RestorePipeline(fetch_workers=self._fetch_workers,
                               decode_workers=self._decode_workers,
                               max_inflight=self._max_inflight)

    @staticmethod
    def _scatter(out: np.ndarray, decoded) -> None:
        # serving replicas keep embedding values only; optimizer row state
        # (aux sections) decodes but is dropped here
        idx, vals, _aux = decoded
        out[idx] = vals

    def _stream(self, plan: "rr.RangePlan", tables: Dict[str, np.ndarray],
                dense_out: Dict[str, np.ndarray]) -> int:
        """Fetch→decode→apply every planned read into ``tables`` and the
        head's dense params into ``dense_out``; returns payload bytes."""
        final = plan.chain[-1]
        pipe = self._pipe()
        try:
            for pr in plan.reads:
                pipe.submit(
                    functools.partial(self.store.get, pr.chunk.key),
                    functools.partial(cp.decode_chunk, pr.man.step,
                                      pr.table, pr.rec, pr.chunk),
                    functools.partial(self._scatter, tables[pr.table]))
            for name, drec in final.dense.items():
                pipe.submit(
                    functools.partial(self.store.get, drec.key),
                    functools.partial(cp.decode_dense, final.step,
                                      name, drec),
                    functools.partial(dense_out.__setitem__, name))
            pipe.drain()
        finally:
            pipe.close()
        self.refresh_bytes_total += pipe.stats.payload_bytes
        return pipe.stats.payload_bytes

    def _full_sync(self, chain: List[mf.Manifest]) -> None:
        """Cold build of the head state into fresh arrays, then install."""
        plan = rr.plan_ranges(chain)
        tables: Dict[str, np.ndarray] = {}
        for man in chain:
            for name, rec in man.tables.items():
                if name not in tables:
                    tables[name] = np.zeros((rec.rows, rec.dim),
                                            dtype=np.float32)
        dense: Dict[str, np.ndarray] = {}
        self._stream(plan, tables, dense)
        self.refresh_rows_total += sum(
            pr.chunk.n_rows for pr in plan.reads)
        self.server.install(tables, dense, chain[-1].step)

    def _apply_suffix(self, suffix: List[mf.Manifest]) -> bool:
        """Replay only the manifests after the applied step, in place, on
        the server's back buffers. ``dirty`` (the delta index's touched
        union — a superset of every row the replay can write) doubles as
        the abort-repair set and the post-publish resync set. Returns
        False when it had to fall back to a full sync."""
        plan = rr.plan_ranges(suffix)
        dirty = touched_union(suffix)
        head = suffix[-1]
        back = self.server.begin_apply()
        for man in suffix:
            for name, rec in man.tables.items():
                have = back.get(name)
                if have is None or have.shape != (rec.rows, rec.dim):
                    # new/resized table mid-stream: incremental state is
                    # unsound, rebuild from the full chain instead
                    self.server.abort(dirty)
                    self._full_sync(self.cache.chain(head.step))
                    return False
        dense: Dict[str, np.ndarray] = {}
        try:
            self._stream(plan, back, dense)
        except BaseException:
            self.server.abort(dirty)
            raise
        self.refresh_rows_total += sum(
            pr.chunk.n_rows for pr in plan.reads)
        self.server.publish(head.step, dirty, dense)
        return True

    # ------------------------------------------------------------- health
    def _ok(self, steps: List[int]) -> None:
        self.health.state = "live"
        self.health.reason = None
        self.health.consecutive_failures = 0
        self.health.held_since_unix = None
        self.health.applied_step = self.applied_step
        self.health.lag_steps = sum(
            1 for s in steps
            if self.applied_step is None or s > self.applied_step)

    def _transient(self, reason: str) -> None:
        self.errors_total += 1
        self.health.state = "retrying" if self.applied_step is not None \
            else "init"
        self.health.reason = reason
        self.health.consecutive_failures += 1

    # ------------------------------------------------------------ metrics
    def metrics(self) -> dict:
        """The ``serve`` section for :func:`repro_torch.core.metrics
        .render_prometheus` — freshness and bytes-per-refresh are the two
        that matter: a replica paying O(model) bytes per step shows up
        immediately as refresh_bytes ≫ the job's touched-row rate."""
        m = self.server.metrics()
        return {
            "state": self.health.state,
            "applied_step": self.applied_step,
            "head_step": self.health.head_step,
            "lag_steps": self.health.lag_steps,
            "consecutive_failures": self.health.consecutive_failures,
            "polls_total": self.polls_total,
            "applied_steps_total": self.applied_steps_total,
            "refresh_bytes_total": self.refresh_bytes_total,
            "refresh_rows_total": self.refresh_rows_total,
            "full_syncs_total": self.full_syncs_total,
            "incremental_refreshes_total": self.incremental_refreshes_total,
            "holds_total": self.holds_total,
            "errors_total": self.errors_total,
            "manifest_cache_hits_total": self.cache.hits,
            "manifest_cache_misses_total": self.cache.misses,
            "last_refresh_wall_s": self.last_refresh_wall_s,
            "version": m["version"],
            "lookups_total": m["lookups_total"],
            "rows_read_total": m["rows_read_total"],
        }
