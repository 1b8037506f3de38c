"""Coordinator-less two-phase commit for sharded checkpoints (§3.4).

Check-N-Run's checkpointing is decentralized: there is no privileged rank.
Every host persists its own part and the checkpoint commits when all parts
are durable. The protocol (see docs/sharded_writers.md for the crash
matrix):

  phase 1 — every host writes its chunk blobs under
            ``chunks/ckpt_<step>/host_<h>/`` and, only once its
            WritePipeline has drained (all chunks durable), publishes its
            :class:`~repro.core.manifest.PartManifest` under
            ``parts/ckpt_<step>/host_<h>.json``. The part manifest IS the
            host's vote: present ⇔ "this host finished storing its part".
  phase 2 — after voting, each host polls the parts namespace
            (``repro.dist.shard_writer.poll_votes_and_commit``). The LAST
            host to observe all ``num_hosts`` votes re-reads every part
            from the store (reading the blob back is the durability proof;
            nothing is trusted from memory), optionally verifies each
            referenced chunk exists with the recorded size, merges the
            parts into one global :class:`~repro.core.manifest.Manifest`
            carrying a ``shards`` map, and writes it. That single manifest
            put is the atomic commit point — a crash anywhere before it
            leaves the previous checkpoint as the latest valid one.

Because any host may believe it is last (votes land while peers poll),
:func:`try_commit` is IDEMPOTENT: the merged manifest is deterministic —
parts merge in host order and every time-dependent field is derived from
the durable votes themselves (``created_unix`` = the newest part's stamp,
no per-committer wall time) — so two racing committers produce
byte-identical manifests and :func:`repro.core.manifest.commit_once`
tolerates the double put (identical bytes ⇒ last-writer-wins is harmless;
divergent bytes raise :class:`~repro.core.manifest.CommitRaceError`).

Aborted saves (missing votes, failed verification, crashes) never commit;
their chunk blobs and part manifests are reclaimed by
:func:`repro.core.manifest.gc_aborted`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from . import manifest as mf
from .storage import ObjectStore
# cycle-free by design: serve.delta_index is numpy-only at module scope
from ..serve.delta_index import build_delta


class ShardCommitError(RuntimeError):
    """A sharded checkpoint cannot commit: a host's part is missing,
    inconsistent with its peers, or references chunks that are not durable."""


@dataclasses.dataclass
class CommitContext:
    """Everything phase 2 needs beyond the durable votes — computed ONCE
    per save attempt (by the manager / launcher) and handed to every host,
    so all potential committers build byte-identical manifests. JSON
    round-trips losslessly (the multiprocess path ships it to host
    processes as a file)."""

    kind: str                      # "full" | "incremental"
    base_step: Optional[int]
    prev_step: Optional[int]
    quant: Optional[dict]
    policy: dict
    extra: Dict[str, Any]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CommitContext":
        return cls(kind=d["kind"], base_step=d.get("base_step"),
                   prev_step=d.get("prev_step"), quant=d.get("quant"),
                   policy=d["policy"], extra=d.get("extra", {}))


# ------------------------------------------------------------------ phase two
def collect_parts(store: ObjectStore, step: int, num_hosts: int,
                  verify_chunks: bool = True
                  ) -> Tuple[List[mf.PartManifest], List[bytes]]:
    """Load and validate all parts for ``step``. Raises
    :class:`ShardCommitError` unless every host 0..num_hosts-1 has a
    durable, self-consistent part."""
    parts: List[mf.PartManifest] = []
    raws: List[bytes] = []
    for host in range(num_hosts):
        key = mf.part_key(step, host)
        try:
            raw = store.get(key)
        except (KeyError, FileNotFoundError):
            present = mf.list_part_hosts(store, step)
            raise ShardCommitError(
                f"step {step}: part for host {host} missing "
                f"(present: {present} of {num_hosts})")
        part = mf.PartManifest.from_json(raw.decode())
        if (part.step, part.host, part.num_hosts) != (step, host, num_hosts):
            raise ShardCommitError(
                f"step {step}: part {key} claims step={part.step} "
                f"host={part.host} num_hosts={part.num_hosts}")
        parts.append(part)
        raws.append(raw)
    if verify_chunks:
        _verify_chunks(store, parts)
    return parts, raws


def _verify_chunks(store: ObjectStore, parts) -> None:
    for part in parts:
        records = [ch for rec in part.tables.values() for ch in rec.chunks]
        records += list(part.dense.values())
        for rec in records:
            if not store.exists(rec.key):
                raise ShardCommitError(
                    f"step {part.step} host {part.host}: chunk "
                    f"{rec.key} not durable")
            if store.size(rec.key) != rec.nbytes:
                raise ShardCommitError(
                    f"step {part.step} host {part.host}: chunk "
                    f"{rec.key} truncated ({store.size(rec.key)} "
                    f"!= {rec.nbytes} bytes)")


def merge_parts(parts) -> Dict[str, Any]:
    """Merge per-host parts into global table/dense records. Chunks are
    concatenated in host order (each host's chunks already in submission
    order), keeping manifest chunk order deterministic. Hosts must agree
    on every table's shape/encoding; dense keys must be owned by exactly
    one host."""
    tables: Dict[str, mf.TableRecord] = {}
    dense: Dict[str, mf.DenseRecord] = {}
    nbytes = 0
    for part in parts:
        nbytes += part.nbytes_total
        for name, rec in part.tables.items():
            if name not in tables:
                tables[name] = mf.TableRecord(
                    rows=rec.rows, dim=rec.dim, dtype=rec.dtype,
                    bits=rec.bits, method=rec.method,
                    row_state=dict(rec.row_state), chunks=[],
                    meta_dtype=rec.meta_dtype)
            agg = tables[name]
            meta = (rec.rows, rec.dim, rec.dtype, rec.bits, rec.method,
                    rec.row_state, rec.meta_dtype)
            agg_meta = (agg.rows, agg.dim, agg.dtype, agg.bits,
                        agg.method, agg.row_state, agg.meta_dtype)
            if meta != agg_meta:
                raise ShardCommitError(
                    f"hosts disagree on table {name!r}: "
                    f"{meta} vs {agg_meta}")
            agg.chunks.extend(rec.chunks)
        for key_name, drec in part.dense.items():
            if key_name in dense:
                raise ShardCommitError(
                    f"dense param {key_name!r} written by two hosts")
            dense[key_name] = drec
    return dict(tables=tables, dense=dense, nbytes_total=nbytes)


def _assemble_manifest(step: int, num_hosts: int, ctx: CommitContext,
                       parts, raws) -> mf.Manifest:
    """Merge collected parts into the deterministic global manifest:
    host-ordered merge; ``created_unix`` is the newest part's stamp and
    ``wall_time_s`` stays 0 — a per-committer wall clock would make racing
    commits diverge byte-wise (per-host timings live in
    :class:`~repro.core.checkpoint.SaveResult`)."""
    merged = merge_parts(parts)
    shards = {
        "num_hosts": num_hosts,
        "parts": [
            dict(host=p.host, key=mf.part_key(step, p.host),
                 crc32=ObjectStore.checksum(raw), nbytes=len(raw))
            for p, raw in zip(parts, raws)
        ],
    }
    return mf.Manifest(
        step=step, kind=ctx.kind, base_step=ctx.base_step,
        prev_step=ctx.prev_step, quant=ctx.quant, policy=ctx.policy,
        tables=merged["tables"], dense=merged["dense"], extra=ctx.extra,
        nbytes_total=merged["nbytes_total"], wall_time_s=0.0,
        created_unix=max(p.created_unix for p in parts), shards=shards,
        layout=mf.make_layout(num_hosts),
        # pure function of the merged records — racing committers stamp
        # byte-identical indexes, keeping commit_once's winner arbitrary
        delta=build_delta(merged["tables"], merged["dense"]))


def build_manifest(store: ObjectStore, step: int, num_hosts: int,
                   ctx: CommitContext,
                   verify_chunks: bool = True) -> mf.Manifest:
    """Construct the global manifest a committer WOULD write — collect all
    votes, verify, merge — without writing it. Deterministic given the
    durable parts and ``ctx`` (see :func:`_assemble_manifest`)."""
    parts, raws = collect_parts(store, step, num_hosts, verify_chunks)
    return _assemble_manifest(step, num_hosts, ctx, parts, raws)


def try_commit(store: ObjectStore, step: int, num_hosts: int,
               ctx: CommitContext,
               verify_chunks: bool = True) -> mf.Manifest:
    """Phase 2, callable by ANY host (or an operator, post-crash): verify
    every vote, merge, write the global manifest. Idempotent — if the step
    is already committed the existing manifest is returned untouched, and
    a racing identical commit is absorbed by
    :func:`repro.core.manifest.commit_once`. Raises
    :class:`ShardCommitError` when the quorum is incomplete or a vote's
    chunks are not durable.

    Several hosts can observe the last vote near-simultaneously, so the
    manifest's existence is re-checked at each expensive boundary (after
    reading the votes, and again after chunk verification) — late entrants
    short-circuit on the winner's manifest instead of all N hosts paying
    the full exists+size pass over every chunk in the store."""
    key = mf.manifest_key(step)
    if store.exists(key):
        return mf.load(store, step)
    parts, raws = collect_parts(store, step, num_hosts, verify_chunks=False)
    if store.exists(key):  # a peer committed while we read the votes
        return mf.load(store, step)
    if verify_chunks:
        _verify_chunks(store, parts)
        if store.exists(key):  # ... or during the chunk verification
            return mf.load(store, step)
    man = _assemble_manifest(step, num_hosts, ctx, parts, raws)
    mf.commit_once(store, man)
    return man


class CommitCoordinator:
    """Single-process convenience wrapper over the coordinator-less commit
    primitives — kept for operational tooling and tests that drive phase 2
    directly. The save path itself no longer routes through a dedicated
    coordinator object: every host runs
    :func:`repro.dist.shard_writer.poll_votes_and_commit` after voting.

    Stateless between calls, so crash-recovery is trivial (re-run the save
    — committed manifests are immutable and orphaned parts are GC'd)."""

    def __init__(self, store: ObjectStore, num_hosts: int,
                 verify_chunks: bool = True) -> None:
        if num_hosts <= 0:
            raise ValueError(f"num_hosts must be positive, got {num_hosts}")
        self.store = store
        self.num_hosts = num_hosts
        self.verify_chunks = verify_chunks

    def ready_hosts(self, step: int) -> List[int]:
        return mf.list_part_hosts(self.store, step)

    def collect(self, step: int):
        return collect_parts(self.store, step, self.num_hosts,
                             self.verify_chunks)

    merge_parts = staticmethod(merge_parts)

    def commit(self, step: int, *, kind: str, base_step: Optional[int],
               prev_step: Optional[int], quant: Optional[dict], policy: dict,
               extra: Dict[str, Any]) -> mf.Manifest:
        """Verify every vote, merge, write the global manifest (idempotent
        — see :func:`try_commit`)."""
        ctx = CommitContext(kind=kind, base_step=base_step,
                            prev_step=prev_step, quant=quant, policy=policy,
                            extra=extra)
        return try_commit(self.store, step, self.num_hosts, ctx,
                          self.verify_chunks)

    # --------------------------------------------------------------- abort
    def abort(self, step: int) -> int:
        """Best-effort reclaim of an aborted save's blobs. Refuses to touch
        a committed step (its manifest exists); otherwise delegates to the
        one reclamation implementation (:func:`manifest.gc_steps`)."""
        if self.store.exists(mf.manifest_key(step)):
            raise ShardCommitError(f"step {step} is committed; use retention")
        return mf.gc_steps(self.store, [step]).get(step, 0)
