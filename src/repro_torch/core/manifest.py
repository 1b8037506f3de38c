"""Checkpoint manifests: the atomic commit record for a Check-N-Run
checkpoint (§3.4 step 3 — "when all nodes finish storing their part of the
checkpoint successfully, Check-N-Run will declare a new valid checkpoint").

A checkpoint is VALID iff its manifest object exists; chunk blobs are written
first, the manifest last. Manifests carry everything needed for recovery:
chunk keys + checksums, quantization parameters, the baseline/previous-step
chain for incremental policies, policy + reader state, and byte accounting.

Sharded (multi-host) checkpoints add one level: each host writes its chunk
blobs under ``chunks/ckpt_<step>/host_<h>/`` and then publishes a
:class:`PartManifest` under ``parts/ckpt_<step>/host_<h>.json`` — the
phase-1 vote of the two-phase commit. The coordinator
(``repro.core.coordinator``) writes the single global manifest (carrying a
``shards`` map plus the merged table records) only once every host's part is
present, so the global manifest key stays the one atomic commit point.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import time
from typing import Any, Dict, Iterable, List, Optional

from .storage import ObjectStore

MANIFEST_PREFIX = "manifests/"
PART_PREFIX = "parts/"
CHUNK_PREFIX = "chunks/"

# Version of the explicit layout record stamped into manifests (below).
# Bump when the partitioning scheme itself changes shape; readers treat
# unknown kinds as unplannable and fall back to whole-table bounds.
LAYOUT_VERSION = 1


def make_layout(num_hosts: int) -> dict:
    """The explicit, versioned shard-layout record for a manifest: how the
    writing job partitioned table rows across hosts. ``row-contiguous`` is
    the only kind today (``row_shard_bounds`` balanced ranges); the record
    exists so the range planner (``core/range_reader.py``) can reason
    about a chain's layouts without sniffing the legacy ``shards`` map."""
    return {"version": LAYOUT_VERSION, "kind": "row-contiguous",
            "num_hosts": int(num_hosts)}


def layout_of(manifest: "Manifest") -> dict:
    """A manifest's layout record, normalized: the explicit record when
    stamped (newer manifests), else version-0 derived from the legacy ``shards``
    map (1 host when unsharded). Every reader goes through this so old
    chains plan identically to new ones."""
    if manifest.layout is not None:
        return manifest.layout
    n = (manifest.shards or {}).get("num_hosts") or 1
    return {"version": 0, "kind": "row-contiguous", "num_hosts": int(n)}

# Backstop for recovery-chain walks over damaged manifests: no sane policy
# produces chains anywhere near this deep (consecutive policies re-baseline
# far sooner), so hitting it means the prev/base links are garbage.
_MAX_CHAIN_LEN = 100_000


def manifest_key(step: int) -> str:
    return f"{MANIFEST_PREFIX}ckpt_{step:012d}.json"


def chunk_prefix(step: int) -> str:
    return f"{CHUNK_PREFIX}ckpt_{step:012d}/"


def part_prefix(step: int) -> str:
    return f"{PART_PREFIX}ckpt_{step:012d}/"


def part_key(step: int, host: int) -> str:
    return f"{part_prefix(step)}host_{host:04d}.json"


def chunk_host_prefix(step: int, host: int) -> str:
    """Per-host chunk namespace. Lives under ``chunk_prefix(step)`` so
    retention's prefix delete reclaims sharded and single-host layouts
    alike."""
    return f"{chunk_prefix(step)}host_{host:04d}/"


def sanitize_key(key: str) -> str:
    """Flatten a param path into one key segment (shared by the single-host
    and per-host dense layouts — the rules must never diverge)."""
    return (key.replace("/", "__").replace(" ", "_").replace("'", "")
            .replace("[", "(").replace("]", ")"))


@dataclasses.dataclass
class ChunkRecord:
    key: str
    n_rows: int
    nbytes: int
    crc32: int
    sections: Dict[str, List[int]]  # name -> [offset, nbytes]
    row_range: Optional[List[int]] = None  # [lo, hi) for full-ckpt range chunks
    # 32-bit content hash of the chunk's primary section (packed codes, or
    # raw values when unquantized), computed ON DEVICE alongside quant_pack
    # (kernels/chunk_hash) — an integrity witness that predates the
    # host-side crc32's coverage. Old manifests omit it; verifiers treat
    # None as "no hash recorded", never as a failure.
    hash32: Optional[int] = None
    # Incremental chunks only: compressed ``[[lo, hi), ...]`` spans of the
    # chunk's GLOBAL row indices (``repro.serve.delta_index.compress_spans``)
    # — a SUPERSET of the rows actually present, at most MAX_CHUNK_SPANS
    # long. Feeds the manifest's delta index and tightens the range
    # planner's per-chunk bounds. Old manifests omit it; readers fall back
    # to the conservative writer-shard / whole-table bound.
    row_spans: Optional[List[List[int]]] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TableRecord:
    rows: int
    dim: int
    dtype: str
    bits: Optional[int]
    method: Optional[str]
    row_state: Dict[str, str]  # aux name -> dtype (per-row optimizer state)
    chunks: List[ChunkRecord]
    # dtype of the per-row scale/zero sections. Old manifests omit it; the
    # reader then falls back to sniffing the section length (fp16 vs fp32).
    meta_dtype: Optional[str] = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["chunks"] = [c if isinstance(c, dict) else dataclasses.asdict(c) for c in self.chunks]
        return d


@dataclasses.dataclass
class DenseRecord:
    key: str
    shape: List[int]
    dtype: str
    nbytes: int
    crc32: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _tables_to_dict(tables: Dict[str, TableRecord]) -> dict:
    return {k: v.to_dict() for k, v in tables.items()}


def _tables_from_dict(d: dict) -> Dict[str, TableRecord]:
    tables = {}
    for name, t in d.items():
        chunks = [ChunkRecord(**c) for c in t.pop("chunks")]
        tables[name] = TableRecord(chunks=chunks, **t)
    return tables


@dataclasses.dataclass
class PartManifest:
    """One host's durable share of a sharded checkpoint (phase-1 vote).

    Published only after every chunk it references is stored; its existence
    means "this host finished storing its part" (paper §3.4). Chunk row
    indices are GLOBAL table rows, so merged parts restore with the same
    scatter path as single-host chunks."""

    step: int
    host: int
    num_hosts: int
    tables: Dict[str, TableRecord]
    dense: Dict[str, DenseRecord]
    nbytes_total: int
    created_unix: float

    def to_json(self) -> str:
        d = dict(
            step=self.step,
            host=self.host,
            num_hosts=self.num_hosts,
            tables=_tables_to_dict(self.tables),
            dense={k: v.to_dict() for k, v in self.dense.items()},
            nbytes_total=self.nbytes_total,
            created_unix=self.created_unix,
        )
        return json.dumps(d, indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "PartManifest":
        d = json.loads(s)
        return cls(
            step=d["step"],
            host=d["host"],
            num_hosts=d["num_hosts"],
            tables=_tables_from_dict(d["tables"]),
            dense={k: DenseRecord(**v) for k, v in d["dense"].items()},
            nbytes_total=d["nbytes_total"],
            created_unix=d.get("created_unix", 0.0),
        )


@dataclasses.dataclass
class Manifest:
    step: int
    kind: str  # "full" | "incremental"
    base_step: Optional[int]
    prev_step: Optional[int]
    quant: Optional[dict]
    policy: dict
    tables: Dict[str, TableRecord]
    dense: Dict[str, DenseRecord]
    extra: Dict[str, Any]
    nbytes_total: int
    wall_time_s: float
    created_unix: float
    # Sharded checkpoints only: {"num_hosts": N, "parts": [{"host", "key",
    # "crc32", "nbytes"}, ...]} over the per-host part manifests merged into
    # ``tables``/``dense``. None for single-host checkpoints.
    shards: Optional[dict] = None
    # Explicit versioned shard-layout record (:func:`make_layout`). Old
    # manifests omit it; readers normalize through :func:`layout_of`.
    layout: Optional[dict] = None
    # Read-optimized delta index stamped at commit time
    # (``repro.serve.delta_index.build_delta``): per-table touched-row
    # spans + payload bytes, so a subscriber costs a catch-up without
    # fetching chunk headers. Old manifests omit it; readers normalize
    # through ``repro.serve.delta_index.delta_of`` (version-0 derivation,
    # same pattern as ``layout``).
    delta: Optional[dict] = None

    def to_json(self) -> str:
        d = dict(
            step=self.step,
            kind=self.kind,
            base_step=self.base_step,
            prev_step=self.prev_step,
            quant=self.quant,
            policy=self.policy,
            tables=_tables_to_dict(self.tables),
            dense={k: v.to_dict() for k, v in self.dense.items()},
            extra=self.extra,
            nbytes_total=self.nbytes_total,
            wall_time_s=self.wall_time_s,
            created_unix=self.created_unix,
            shards=self.shards,
            layout=self.layout,
            delta=self.delta,
        )
        return json.dumps(d, indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Manifest":
        d = json.loads(s)
        dense = {k: DenseRecord(**v) for k, v in d["dense"].items()}
        return cls(
            step=d["step"],
            kind=d["kind"],
            base_step=d.get("base_step"),
            prev_step=d.get("prev_step"),
            quant=d.get("quant"),
            policy=d["policy"],
            tables=_tables_from_dict(d["tables"]),
            dense=dense,
            extra=d.get("extra", {}),
            nbytes_total=d["nbytes_total"],
            wall_time_s=d.get("wall_time_s", 0.0),
            created_unix=d.get("created_unix", 0.0),
            shards=d.get("shards"),
            layout=d.get("layout"),
            delta=d.get("delta"),
        )


def commit(store: ObjectStore, manifest: Manifest) -> None:
    store.put(manifest_key(manifest.step), manifest.to_json().encode())


class CommitRaceError(RuntimeError):
    """Two committers produced DIFFERENT manifest bytes for the same step —
    a protocol violation (sharded commits must be deterministic)."""


def commit_once(store: ObjectStore, manifest: Manifest) -> bool:
    """Compare-and-commit for coordinator-less phase 2: any number of
    racing committers may call this with byte-identical manifests; exactly
    one logical commit results. Returns True if this call wrote the
    manifest, False if an identical one was already durable. Raises
    :class:`CommitRaceError` if a DIFFERENT manifest exists for the step
    (deterministic serialization is the protocol invariant — see
    ``repro.core.coordinator.build_manifest``).

    The exists→put window is benign: if two racing committers both pass the
    check, both put identical bytes and the store's last-writer-wins
    semantics make the second put a no-op in effect."""
    key = manifest_key(manifest.step)
    data = manifest.to_json().encode()
    if store.exists(key):
        try:
            existing = store.get(key)
        except (KeyError, FileNotFoundError):  # pragma: no cover - narrow race
            existing = None
        if existing == data:
            return False
        raise CommitRaceError(
            f"step {manifest.step}: a different manifest is already "
            f"committed ({len(existing) if existing is not None else '?'} "
            f"bytes vs {len(data)} proposed)")
    store.put(key, data)
    return True


def load(store: ObjectStore, step: int) -> Manifest:
    return Manifest.from_json(store.get(manifest_key(step)).decode())


def publish_part(store: ObjectStore, part: PartManifest) -> str:
    """Phase-1 vote: durably record one host's finished part. Must only be
    called after every chunk the part references is stored."""
    key = part_key(part.step, part.host)
    store.put(key, part.to_json().encode())
    return key


def load_part(store: ObjectStore, step: int, host: int) -> PartManifest:
    return PartManifest.from_json(store.get(part_key(step, host)).decode())


def list_part_hosts(store: ObjectStore, step: int) -> List[int]:
    """Hosts whose part manifests for ``step`` are durable."""
    hosts = []
    prefix = part_prefix(step)
    for key in store.list(prefix):
        name = key[len(prefix):]
        if name.startswith("host_") and name.endswith(".json"):
            hosts.append(int(name[len("host_"): -len(".json")]))
    return sorted(hosts)


def list_steps(store: ObjectStore) -> List[int]:
    steps = []
    for key in store.list(MANIFEST_PREFIX):
        name = key[len(MANIFEST_PREFIX):]
        if name.startswith("ckpt_") and name.endswith(".json"):
            steps.append(int(name[len("ckpt_"): -len(".json")]))
    return sorted(steps)


def latest_step(store: ObjectStore) -> Optional[int]:
    steps = list_steps(store)
    return steps[-1] if steps else None


def recovery_chain(store: ObjectStore, step: int,
                   load_fn=None) -> List[Manifest]:
    """Manifests to replay (oldest→newest) to reconstruct state at ``step``.

    * full checkpoint: [m]
    * one-shot / intermittent increment (cumulative): [base, m]
    * consecutive increment: [base, inc_1, ..., m] following prev_step links.

    ``load_fn(step) -> Manifest`` overrides the per-step manifest load —
    committed manifests are immutable, so a polling subscriber walks the
    same chain every few seconds and a validated cache
    (``repro.serve.subscriber.ManifestCache``) makes the steady-state walk
    free of store reads. Default: uncached :func:`load`.
    """
    if load_fn is None:
        load_fn = functools.partial(load, store)
    m = load_fn(step)
    if m.kind == "full":
        return [m]
    chain = [m]
    cursor = m
    # A corrupt or hand-edited manifest can point its prev/base link at
    # itself, forward, or around a cycle — without these guards the walk
    # never terminates (or "recovers" a step from data written after it).
    # Steps are monotone, so every legal link points strictly backward.
    seen = {m.step}
    while cursor.kind != "full":
        prev = cursor.prev_step if cursor.policy.get("name") == "consecutive" else cursor.base_step
        if prev is None:
            raise ValueError(f"broken recovery chain at step {cursor.step}")
        if prev >= cursor.step:
            raise ValueError(
                f"corrupt recovery chain: step {cursor.step} points "
                f"{'at itself' if prev == cursor.step else 'forward'} "
                f"(prev/base {prev})")
        if prev in seen:
            raise ValueError(
                f"corrupt recovery chain: cycle through step {prev} "
                f"(visited {sorted(seen)})")
        seen.add(prev)
        if len(seen) > _MAX_CHAIN_LEN:
            raise ValueError(
                f"recovery chain for step {step} exceeds {_MAX_CHAIN_LEN} "
                f"links without reaching a full checkpoint")
        cursor = load_fn(prev)
        chain.append(cursor)
    chain.reverse()
    if chain[0].kind != "full":
        raise ValueError("recovery chain does not start at a full checkpoint")
    return chain


def reachable_steps(store: ObjectStore, keep_steps: List[int]) -> set:
    """All steps needed to restore any of ``keep_steps`` (chain closure)."""
    needed = set()
    for s in keep_steps:
        for m in recovery_chain(store, s):
            needed.add(m.step)
    return needed


def apply_retention(store: ObjectStore, keep_latest: int = 1,
                    ttl_days: float = 14.0, now: Optional[float] = None) -> List[int]:
    """Delete checkpoints beyond the newest ``keep_latest`` (and their chain
    dependencies) or older than ``ttl_days`` (paper §3.4: default keeps only
    the latest valid checkpoint, stored <= 14 days). Returns deleted steps."""
    now = time.time() if now is None else now
    steps = list_steps(store)
    if not steps:
        return []
    keep = steps[-keep_latest:] if keep_latest > 0 else []
    needed = reachable_steps(store, keep)
    deleted = []
    for s in steps:
        m = load(store, s)
        expired = (now - m.created_unix) > ttl_days * 86400.0
        if s in needed and not expired:
            continue
        if s in needed and expired and s in keep:
            continue  # never delete the newest valid checkpoint
        for key in store.list(chunk_prefix(s)):
            store.delete(key)
        for key in store.list(part_prefix(s)):
            store.delete(key)
        store.delete(manifest_key(s))
        deleted.append(s)
    return deleted


def _steps_under(store: ObjectStore, prefix: str) -> set:
    """Steps that own blobs under ``prefix`` ("<prefix>ckpt_<step>/...")."""
    steps = set()
    plen = len(prefix)
    for key in store.list(prefix):
        name = key[plen:]
        if not name.startswith("ckpt_"):
            continue
        digits = name[len("ckpt_"):].split("/", 1)[0]
        if digits.isdigit():
            steps.add(int(digits))
    return steps


def aborted_steps(store: ObjectStore) -> List[int]:
    """Steps with chunk blobs or part manifests but NO committed global
    manifest — the debris of crashed or cancelled saves."""
    committed = set(list_steps(store))
    orphans = (_steps_under(store, CHUNK_PREFIX)
               | _steps_under(store, PART_PREFIX)) - committed
    return sorted(orphans)


def _step_of_key(key: str, prefix: str) -> Optional[int]:
    name = key[len(prefix):]
    if not name.startswith("ckpt_"):
        return None
    digits = name[len("ckpt_"):].split("/", 1)[0].split(".", 1)[0]
    return int(digits) if digits.isdigit() else None


def gc_aborted(store: ObjectStore, exclude_steps: Iterable[int] = (),
               fence: Optional[str] = "latest",
               skipped_out: Optional[set] = None) -> Dict[int, int]:
    """Reclaim chunk blobs and part manifests of aborted saves (no global
    manifest ⇒ the checkpoint never committed, per §3.4 its blobs are
    garbage). Returns ``{step: deleted_key_count}``.

    With coordinator-less commits ANY host can commit a step concurrently
    with a sweep, so two guards protect live data:

    * ``fence="latest"`` (default): steps newer than the latest committed
      manifest are never touched — checkpoint steps are monotone, so an
      in-flight save is always newer than the last commit and its blobs
      (durable votes included) must not be reclaimed mid-save.
      ``fence=None`` disables this (CLI ``gc-aborted --all``, for operators
      who know no writer is active).
    * every step's deletion batch re-checks the step's manifest immediately
      before deleting — a step that committed mid-sweep (between the
      namespace listing and the batch) is skipped, closing the
      check-then-delete race.

    Single pass over each blob namespace (listed exactly once, deletions
    grouped per step from those listings) — this runs on the writer thread
    after every committed save, so it must not re-walk the store per
    aborted step. ``skipped_out`` (a set, mutated) collects the steps the
    fence protected, in the same pass — the manager parks them and
    reclaims each once its own committed steps pass it, without paying a
    second namespace walk to discover them."""
    committed = set(list_steps(store))
    latest = max(committed) if committed else None
    excluded = set(exclude_steps) | committed
    by_step: Dict[int, List[str]] = {}
    # PART_PREFIX first: within each step's batch the votes are deleted
    # BEFORE the chunks, so a commit racing past the re-check below fails
    # its own collect (vote missing) rather than committing a manifest
    # whose chunk blobs this sweep is about to remove.
    for prefix in (PART_PREFIX, CHUNK_PREFIX):
        for key in store.list(prefix):
            s = _step_of_key(key, prefix)
            if s is None or s in excluded:
                continue
            if fence == "latest" and (latest is None or s > latest):
                if skipped_out is not None:
                    skipped_out.add(s)
                continue  # possibly an in-flight save — never reclaim
            by_step.setdefault(s, []).append(key)
    reclaimed: Dict[int, int] = {}
    for s in sorted(by_step):
        n = _delete_step_batch(store, s, by_step[s])
        if n:
            reclaimed[s] = n
    return reclaimed


def _delete_step_batch(store: ObjectStore, s: int,
                       keys: List[str]) -> int:
    """Delete one aborted step's blobs (``keys`` ordered votes-first) with
    the commit-race guards: re-check the step's manifest immediately
    before the batch, and again after the votes are gone but before any
    chunk blob is touched. A committer that was already past its own
    collect when the sweep started usually lands inside one of those two
    checks — its manifest then keeps every chunk (restore never reads the
    parts; ``ckpt verify`` / ``integrity.scan_step`` classify the missing
    votes as benign ``reclaimed-part`` when the payload is intact, and
    only exit non-zero for parts missing alongside payload damage). The
    guards NARROW rather than close the race: a commit put
    landing after the second check, mid-chunk-deletion, still tears the
    step. Closing it needs store-side transactions; until then the
    operating rule stands — never run offline commits (``ckpt commit``)
    concurrently with sweeps, and ``ckpt commit`` re-verifies its chunks
    after committing and rolls back if any were swept."""
    if store.exists(manifest_key(s)):
        return 0  # committed mid-sweep — its blobs are live now
    deleted = 0
    for i, key in enumerate(keys):
        if key.startswith(CHUNK_PREFIX):
            # votes are gone: any commit attempt STARTING now fails its
            # collect; one final check catches an attempt that was already
            # merging before we swept
            if store.exists(manifest_key(s)):
                return deleted
            for chunk_key in keys[i:]:
                store.delete(chunk_key)
                deleted += 1
            break
        store.delete(key)
        deleted += 1
    return deleted


def gc_steps(store: ObjectStore, steps: Iterable[int]) -> Dict[int, int]:
    """Targeted variant of :func:`gc_aborted`: reclaim only the named
    steps' blobs (skipping any that committed). Lets the manager clean the
    aborts it witnessed without sweeping the whole namespace every save."""
    reclaimed: Dict[int, int] = {}
    for s in sorted(set(steps)):
        if store.exists(manifest_key(s)):
            continue
        # votes first (see _delete_step_batch): a racing commit loses its
        # quorum before any chunk blob disappears
        keys = (list(store.list(part_prefix(s)))
                + list(store.list(chunk_prefix(s))))
        n = _delete_step_batch(store, s, keys)
        if n:
            reclaimed[s] = n
    return reclaimed
