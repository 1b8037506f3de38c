"""Per-host shard writers for sharded multi-host checkpointing (§3.4), in
PyTorch.

Each host — a thread in the simulated path, its own OS process under
``repro_torch.dist.host_proc`` — owns a contiguous row-shard of every
embedding table
(``repro_torch.dist.sharding.row_shard_bounds``) and runs its OWN
:class:`~repro_torch.core.pipeline.WritePipeline` over that shard: encode
workers, upload workers, bounded in-flight window — exactly the
single-host engine, instantiated once per host. Chunk blobs go under the
host's key prefix (``chunks/ckpt_<step>/host_<h>/``); once the pipeline
drains, the host publishes its part manifest (phase-1 vote, see
``repro_torch.core.coordinator``), then enters phase 2 itself: it polls the
parts namespace and the LAST host to observe all votes performs the merge
and writes the global manifest (:func:`poll_votes_and_commit`) — no
dedicated coordinator rank exists.

Chunk row indices stay GLOBAL, so a merged sharded checkpoint restores
through the unchanged scatter path — byte-identically to a single-host save
of the same snapshot (quantization is row-wise, hence partition-invariant).
One carve-out: ``aux_bits=8`` compresses optimizer aux with per-CHUNK
min/max ranges, and the chunk partition shifts with the shard layout, so
that lossy-aux config reconstructs aux within its quantization error but
not bit-for-bit across different ``num_hosts``.

Encoding (quantize → pack → checksum) is delegated to the ``encoder``
collaborator (the :class:`~repro_torch.core.checkpoint.CheckNRunManager`),
so the byte format has exactly one implementation: every host's chunks go
through the same ``quant_pack`` and ``chunk_hash`` kernels on the card
(their plain versions on the CPU), carry the per-chunk content ``hash32``
and are covered by ``scan_store`` exactly like single-host chunks. On one
card the hosts' encode workers all queue on the same device (one context
for thread hosts, one a process for host processes). The part
manifests written here are what ``scan_store`` classifies as benign
``reclaimed-part`` debris after retention deletes a step's payload.
"""

from __future__ import annotations

import functools
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from ..core import manifest as mf
from ..core.coordinator import CommitContext, try_commit
from ..core.storage import CheckpointCancelled, ObjectStore
from .sharding import row_shard_bounds


def dense_owner(name: str, num_hosts: int) -> int:
    """Stable assignment of a dense param to the host that writes it."""
    return zlib.crc32(name.encode()) % num_hosts


def _add_note(exc: BaseException, note: str) -> None:
    """``BaseException.add_note`` with a pre-3.11 fallback (the note still
    lands in ``__notes__``; 3.11+ tracebacks render it)."""
    try:
        exc.add_note(note)
    except AttributeError:
        notes = getattr(exc, "__notes__", None)
        if notes is None:
            notes = []
            exc.__notes__ = notes
        notes.append(note)


def await_quorum(store: ObjectStore, step: int, num_hosts: int, *,
                 poll_interval_s: float = 0.02, timeout_s: float = 120.0,
                 cancel=None, observe_commit: bool = True,
                 hard_deadline: Optional[float] = None) -> str:
    """Poll the parts namespace until the full phase-1 quorum is durable
    (``"quorum"``), the global manifest appears (``"committed"``, unless
    ``observe_commit=False`` — tests pin a host to the committer path with
    that), or the quorum stops making progress (``"timeout"`` — a peer
    died before voting). A set ``cancel`` event raises
    :class:`~repro_torch.core.storage.CheckpointCancelled` so thread-simulated
    hosts abort promptly when a peer fails.

    ``timeout_s`` bounds time WITHOUT PROGRESS, not total wait: a freshly
    observed vote resets the clock, and when the clock does run out the
    missing hosts' chunk namespaces are probed once — a straggler still
    durably writing its shard also resets it. So a healthy save is never
    aborted for skew between the first and last voter, while a truly dead
    peer (nothing new durable for ``timeout_s``) still trips it.

    ``hard_deadline`` (a ``time.monotonic()`` instant — the save's
    ``write_deadline_s``) caps the wait regardless of progress: when the
    whole save must be over by T, its phase 2 must be too."""
    deadline = time.monotonic() + timeout_s
    votes_seen = -1
    chunk_counts: dict = {}
    wanted = set(range(num_hosts))

    def committed() -> bool:
        return observe_commit and store.exists(mf.manifest_key(step))

    while True:
        # the durable manifest outranks a cancellation: once the last voter
        # committed, the checkpoint IS valid — raising Cancelled here would
        # skip the manager's post-commit bookkeeping for a committed step
        # (the multiprocess path trusts the store the same way)
        if committed():
            return "committed"
        if cancel is not None and cancel.is_set():
            raise CheckpointCancelled(f"phase-2 poll for step {step}")
        present = wanted & set(mf.list_part_hosts(store, step))
        if present == wanted:
            return "quorum"
        if len(present) > votes_seen:
            votes_seen = len(present)
            deadline = time.monotonic() + timeout_s  # progress: reset clock
        if hard_deadline is not None and time.monotonic() >= hard_deadline:
            return "timeout"  # the save's write deadline: no extensions
        if time.monotonic() >= deadline:
            # last chance: probe the missing hosts' chunk namespaces (one
            # listing per host per timeout window, not per poll) — a
            # straggler mid-shard is alive, only its vote is late
            progressed = False
            for h in sorted(wanted - present):
                n = len(list(store.list(mf.chunk_host_prefix(step, h))))
                if n > chunk_counts.get(h, 0):
                    chunk_counts[h] = n
                    progressed = True
            if not progressed:
                return "timeout"
            deadline = time.monotonic() + timeout_s
        if cancel is not None:
            if cancel.wait(timeout=poll_interval_s):
                if committed():  # cancel landed just after the commit
                    return "committed"
                raise CheckpointCancelled(f"phase-2 poll for step {step}")
        else:
            time.sleep(poll_interval_s)


def poll_votes_and_commit(store: ObjectStore, step: int, num_hosts: int,
                          ctx: CommitContext, *, verify_chunks: bool = True,
                          poll_interval_s: float = 0.02,
                          timeout_s: float = 120.0,
                          cancel=None,
                          hard_deadline: Optional[float] = None) -> str:
    """Phase 2 of the coordinator-less commit, run by EVERY host after its
    vote is durable: poll the parts namespace until either the global
    manifest appears (a peer committed — return ``"observed"``) or all
    ``num_hosts`` votes are present, in which case THIS host merges and
    commits (return ``"committed"``). The commit is idempotent
    (:func:`repro_torch.core.coordinator.try_commit`), so the race where several
    hosts each believe they observed the last vote is harmless — they all
    write byte-identical manifests.

    At least one host always sees the full quorum: whichever host's vote
    became durable last checks the namespace only after its own vote, at
    which point every vote is durable. Polling (rather than a single
    check) additionally lets surviving hosts commit a save whose
    true last voter died between voting and committing."""
    got = await_quorum(store, step, num_hosts,
                       poll_interval_s=poll_interval_s, timeout_s=timeout_s,
                       cancel=cancel, hard_deadline=hard_deadline)
    if got != "quorum":
        return "observed" if got == "committed" else got
    try_commit(store, step, num_hosts, ctx, verify_chunks)
    return "committed"


class HostShardWriter:
    """One simulated host's write engine for one checkpoint attempt."""

    def __init__(self, host: int, num_hosts: int, store: ObjectStore,
                 encoder, cancel=None, deadline: Optional[float] = None) -> None:
        self.host = host
        self.num_hosts = num_hosts
        self.store = store
        self.enc = encoder
        self.cancel = cancel
        self.deadline = deadline
        self.stats: Dict[str, float] = {}

    def write_part(self, snap, decision: str, qcfg, cum, unc) -> mf.PartManifest:
        """Write this host's shard of ``snap`` and publish its part manifest.
        Returns only after the vote is durable; raises on any failure, in
        which case NO part manifest exists for this host.

        Chunk emission goes through the encoder's shared plumbing
        (``_submit_table_chunks`` / ``_make_table_record``) — the host key
        prefix and the row-range selection are the only differences from the
        single-host path, which is what keeps restores byte-identical."""
        from ..core.checkpoint import _QuantClock

        step = snap.step
        full = decision == "full"
        prefix = mf.chunk_host_prefix(step, self.host)
        clock = _QuantClock()
        pipe = self.enc._make_pipeline(self.cancel, self.deadline)
        table_futs: Dict[str, list] = {}
        table_shape: Dict[str, tuple] = {}
        dense_futs: Dict[str, object] = {}
        try:
            for name, tab in snap.tables.items():
                rows, dim = tab.shape
                lo, hi = row_shard_bounds(rows, self.num_hosts)[self.host]
                sel = self.enc._select_rows(decision, name, rows, cum, unc,
                                            row_range=(lo, hi))
                aux = snap.row_state.get(name, {})
                table_futs[name] = self.enc._submit_table_chunks(
                    pipe, name, tab, sel, aux, qcfg, full, prefix, clock)
                table_shape[name] = (rows, dim, str(tab.dtype), aux)

            for key_name, arr in snap.dense.items():
                if dense_owner(key_name, self.num_hosts) != self.host:
                    continue
                key = f"{prefix}dense/{mf.sanitize_key(key_name)}.bin"
                encode_fn = functools.partial(self.enc._encode_dense_job,
                                              key, arr)
                write_fn = functools.partial(self.store.put, key)
                dense_futs[key_name] = pipe.submit(encode_fn, write_fn)

            pipe.drain()  # every chunk durable (or raise — no vote)
        finally:
            pipe.close()
        # batch-fsync stores defer chunk dirent flushes; settle them HERE,
        # before the vote below can land — a durable part manifest must
        # imply durable chunks (publish_part's own durable-prefix put would
        # also trigger the flush; this makes the ordering explicit)
        flush = getattr(self.store, "flush_dirs", None)
        if flush is not None:
            flush()

        tables: Dict[str, mf.TableRecord] = {}
        nbytes = 0
        for name, futs in table_futs.items():
            rows, dim, dtype, aux = table_shape[name]
            chunks = [f.result() for f in futs]
            nbytes += sum(c.nbytes for c in chunks)
            tables[name] = self.enc._make_table_record(rows, dim, dtype, aux,
                                                       qcfg, chunks)
        dense: Dict[str, mf.DenseRecord] = {}
        for key_name, fut in dense_futs.items():
            dense[key_name] = fut.result()
            nbytes += dense[key_name].nbytes

        part = mf.PartManifest(
            step=step, host=self.host, num_hosts=self.num_hosts,
            tables=tables, dense=dense, nbytes_total=nbytes,
            created_unix=time.time())
        mf.publish_part(self.store, part)  # the phase-1 vote

        st = pipe.stats
        self.stats = dict(
            host=self.host, items=st.items, payload_bytes=st.payload_bytes,
            quantize_s=clock.seconds, encode_busy_s=st.encode_busy_s,
            write_busy_s=st.write_busy_s, wall_s=st.wall_s,
            occupancy=pipe.occupancy())
        return part


def run_host_writers(writers: List[HostShardWriter], snap, decision: str,
                     qcfg, cum, unc,
                     ctx: Optional[CommitContext] = None,
                     verify_chunks: bool = True,
                     commit_timeout_s: float = 120.0,
                     commit_poll_s: float = 0.02
                     ) -> List[mf.PartManifest]:
    """Run every host's write concurrently (simulated hosts = threads).
    With a :class:`~repro_torch.core.coordinator.CommitContext`, each host also
    runs phase 2 after voting (:func:`poll_votes_and_commit`) — the last
    voter commits the global manifest, so by the time this returns
    successfully the checkpoint IS committed, with no coordinator rank in
    the path.

    The first real failure sets the shared cancel event, so surviving hosts
    abort at their next pipeline checkpoint (or their phase-2 poll) instead
    of finishing doomed shards (and publishing votes the retry would have
    to purge). Waits for all hosts to settle, then re-raises the root
    failure, preferring a real error over a derived CheckpointCancelled so
    a host crash is never misreported as a cancellation; every OTHER host's
    real failure is attached to the root as an exception note, so a
    multi-host failure stays fully diagnosable from one traceback."""
    def guarded(w: HostShardWriter):
        try:
            part = w.write_part(snap, decision, qcfg, cum, unc)
            if ctx is not None:
                outcome = poll_votes_and_commit(
                    w.store, snap.step, w.num_hosts, ctx,
                    verify_chunks=verify_chunks,
                    poll_interval_s=commit_poll_s,
                    timeout_s=commit_timeout_s, cancel=w.cancel,
                    # the save's write deadline also bounds phase 2 —
                    # without it, voters whose peer dies AT the deadline
                    # would poll on for the whole quorum timeout
                    hard_deadline=w.deadline)
                if outcome == "timeout":
                    if (w.deadline is not None
                            and time.monotonic() >= w.deadline):
                        # the save's write deadline expired — same
                        # classification as a pipeline deadline abort, so
                        # the manager reports a cancelled save, not a
                        # protocol failure
                        raise CheckpointCancelled(
                            f"write deadline during phase 2 of step "
                            f"{snap.step}")
                    raise RuntimeError(
                        f"host {w.host}: phase-2 quorum for step "
                        f"{snap.step} never formed within "
                        f"{commit_timeout_s}s of the last observed "
                        f"progress")
            return part
        except CheckpointCancelled:
            raise
        except BaseException:
            if w.cancel is not None:
                w.cancel.set()  # fail fast: per-save event, reset next save
            raise

    with ThreadPoolExecutor(max_workers=len(writers),
                            thread_name_prefix="cnr-host") as pool:
        futs = [pool.submit(guarded, w) for w in writers]
        excs = [f.exception() for f in futs]
    root = None
    root_host = None
    for host, e in enumerate(excs):
        if e is not None and not isinstance(e, CheckpointCancelled):
            root, root_host = e, host
            break
    if root is None:
        root, root_host = next(
            ((e, h) for h, e in enumerate(excs) if e is not None),
            (None, None))
    if root is not None:
        _add_note(root, f"sharded save step {snap.step}: raised by host "
                        f"{root_host} of {len(writers)}")
        for host, e in enumerate(excs):
            if e is None or e is root or isinstance(e, CheckpointCancelled):
                continue  # cancellations are derived, not independent causes
            _add_note(root,
                      f"host {host} also failed: {type(e).__name__}: {e}")
        raise root
    return [f.result() for f in futs]
