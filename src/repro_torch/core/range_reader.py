"""Range planner: layout-independent restore over a committed chain.

The write side partitions each table into contiguous *writer shards*
(``row_shard_bounds``) and namespaces every host's chunk blobs under
``chunks/ckpt_<step>/host_<h>/``. The read side, historically, mirrored
that layout: ``restore_part`` replayed exactly one writer shard and
refused chains whose steps were written under a different ``num_hosts``.

This module breaks that coupling. Chunk row indices are GLOBAL table
rows (full chunks carry an explicit ``row_range``; incremental chunks an
``indices`` section of global uint32 rows), so every chunk's row span
can be bounded WITHOUT fetching it:

* full chunks — exact: the manifest's ``row_range``;
* sharded incremental chunks — the writing host's writer-shard range
  under the SOURCE layout (hosts only ever select rows they own);
* single-host incremental chunks — the whole table (no tighter bound
  is recorded).

Given a committed chain and an arbitrary per-table target row range,
:func:`plan_ranges` resolves the minimal chunk set across the union of
ALL source shards whose bound intersects the target, preserving chain
replay order. The executor (``CheckNRunManager._replay_plan``) streams
the plan through the existing fetch→decode→ordered-apply pipeline and
slice-applies only the intersecting rows (:func:`clip_decoded`), so a
job checkpointed at N hosts restores at N±k hosts with every new host
reading bytes proportional to its own target shard — elastic resharding
(docs/resharding.md).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import manifest as mf

_HOST_SEG = re.compile(r"/host_(\d+)/")


def row_shard_bounds(rows: int, num_hosts: int) -> List[Tuple[int, int]]:
    """Contiguous row ranges ``[(lo, hi), ...]`` assigning a table's rows to
    ``num_hosts`` hosts. Balanced to within one row (the first
    ``rows % num_hosts`` hosts take the extra), covers every row exactly
    once, and degrades to empty ranges when ``rows < num_hosts`` so tiny
    tables stay valid on any host count. Canonical here (the layout math
    the planner inverts); ``repro.dist.sharding`` re-exports it for the
    write side."""
    if num_hosts <= 0:
        raise ValueError(f"num_hosts must be positive, got {num_hosts}")
    base, extra = divmod(max(rows, 0), num_hosts)
    bounds = []
    lo = 0
    for h in range(num_hosts):
        hi = lo + base + (1 if h < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def host_of_chunk_key(key: str) -> Optional[int]:
    """The writing host encoded in a chunk key's ``host_<h>/`` namespace
    segment, or None for single-host chunk keys."""
    m = _HOST_SEG.search(key)
    return int(m.group(1)) if m else None


def chunk_row_bound(rec: mf.TableRecord, ch: mf.ChunkRecord,
                    src_num_hosts: int) -> Tuple[int, int, bool]:
    """Conservative global-row bound ``(lo, hi, exact)`` for one chunk,
    derived purely from the manifest (no blob fetch). ``exact`` is True
    when every row in ``[lo, hi)`` is known to be present (range-encoded
    full chunks); otherwise the chunk's rows are a SUBSET of the bound."""
    if ch.row_range is not None:
        lo, hi = ch.row_range
        return int(lo), int(hi), True
    spans = getattr(ch, "row_spans", None)
    if spans:
        # compressed touched-row spans (serve/delta_index): the envelope
        # [first lo, last hi) is tighter than any writer-shard bound, but
        # gaps between spans mean it is still only a superset
        return int(spans[0][0]), int(spans[-1][1]), False
    host = host_of_chunk_key(ch.key)
    if host is not None and src_num_hosts > 1:
        # incremental sharded chunk: the writer only selects rows inside
        # its own writer shard (dist/shard_writer restricts selection to
        # row_shard_bounds(rows, num_hosts)[host])
        bounds = row_shard_bounds(rec.rows, src_num_hosts)
        if 0 <= host < src_num_hosts:
            lo, hi = bounds[host]
            return lo, hi, False
    return 0, rec.rows, False


def chunk_row_spans(rec: mf.TableRecord, ch: mf.ChunkRecord,
                    src_num_hosts: int) -> List[List[int]]:
    """Superset ``[lo, hi)`` spans of one chunk's global rows, preferring
    the stamped compressed spans (incremental chunks written with the
    delta index) over the single conservative bound. Used by the serving
    layer to size resync copies; always covers every row in the chunk."""
    spans = getattr(ch, "row_spans", None)
    if spans:
        return [[int(lo), int(hi)] for lo, hi in spans]
    lo, hi, _ = chunk_row_bound(rec, ch, src_num_hosts)
    return [[lo, hi]]


def shard_targets(tables: Dict[str, mf.TableRecord], host: int,
                  num_hosts: int) -> Dict[str, List[int]]:
    """Per-table target row range for one host under a (possibly new)
    contiguous layout — what ``restore_part(host, num_hosts=N)`` owns."""
    return {name: list(row_shard_bounds(rec.rows, num_hosts)[host])
            for name, rec in tables.items()}


class RangeCoverageError(ValueError):
    """A planned target range cannot be covered from the chain's recorded
    chunks: the baseline full step is missing rows inside the target."""


@dataclasses.dataclass
class PlannedRead:
    """One chunk the plan will fetch, with enough context to decode and
    clip it: the owning manifest (step), table record, chunk record, and
    its conservative row bound."""
    man: mf.Manifest
    table: str
    rec: mf.TableRecord
    chunk: mf.ChunkRecord
    bound: Tuple[int, int, bool]


@dataclasses.dataclass
class RangePlan:
    """Resolved read set for a target range over a committed chain."""
    chain: List[mf.Manifest]
    targets: Optional[Dict[str, List[int]]]  # None = full range
    reads: List[PlannedRead]  # chain replay order (oldest→newest)
    chunk_bytes: int
    dense_bytes: int
    chunks_total: int
    chunks_skipped: int
    source_layouts: List[int]  # num_hosts per chain step (oldest→newest)

    @property
    def nbytes(self) -> int:
        return self.chunk_bytes + self.dense_bytes


def _intersects(bound: Tuple[int, int, bool], lo: int, hi: int) -> bool:
    return bound[0] < hi and lo < bound[1]


def plan_ranges(chain: List[mf.Manifest],
                targets: Optional[Dict[str, List[int]]] = None, *,
                check_coverage: bool = False) -> RangePlan:
    """Resolve the chunks to fetch for ``targets`` (``{table: [lo, hi)}``;
    None → every table's full range) over a committed recovery chain.

    Selection is layout-independent: a chunk is planned iff its
    :func:`chunk_row_bound` intersects the table's target, regardless of
    which writer shard produced it — so the SAME planner serves full
    restores, same-layout partial recovery, and resharded reads. Plan
    order preserves the chain replay order exactly (chain step → table →
    chunk), keeping the ordered applier's overwrite semantics identical
    to the pre-planner replay.

    ``check_coverage`` asserts (per table, against full-kind chain steps
    whose chunks are range-encoded) that the union of exact row ranges
    covers the target — raising :class:`RangeCoverageError` with the
    missing span otherwise. Tables whose baseline carries no row-range
    chunks (legacy manifests) are exempt: no bound means no witness
    either way."""
    reads: List[PlannedRead] = []
    chunk_bytes = 0
    total = 0
    skipped = 0
    layouts = [layout_num_hosts(man) for man in chain]
    covered: Dict[str, List[Tuple[int, int]]] = {}
    rows_of: Dict[str, int] = {}

    for man, src_n in zip(chain, layouts):
        for name, rec in man.tables.items():
            if targets is not None and name not in targets:
                continue
            if targets is not None:
                tlo, thi = targets[name]
            else:
                tlo, thi = 0, rec.rows
            rows_of.setdefault(name, rec.rows)
            for ch in rec.chunks:
                if ch.n_rows == 0:
                    continue
                total += 1
                bound = chunk_row_bound(rec, ch, src_n)
                if not _intersects(bound, tlo, thi):
                    skipped += 1
                    continue
                reads.append(PlannedRead(man, name, rec, ch, bound))
                chunk_bytes += ch.nbytes
                if man.kind == "full" and bound[2]:
                    covered.setdefault(name, []).append(bound[:2])

    if check_coverage and targets is not None:
        baseline = chain[0]
        for name, (tlo, thi) in targets.items():
            rec = baseline.tables.get(name)
            if rec is None:
                continue
            if not any(c.row_range is not None for c in rec.chunks):
                continue  # legacy: no range metadata to witness coverage
            lo = max(tlo, 0)
            hi = min(thi, rows_of.get(name, rec.rows))
            if lo >= hi:
                continue
            spans = sorted(covered.get(name, []))
            cursor = lo
            for slo, shi in spans:
                if slo > cursor:
                    break
                cursor = max(cursor, shi)
                if cursor >= hi:
                    break
            if cursor < hi:
                raise RangeCoverageError(
                    f"table {name!r}: rows [{cursor}, {hi}) of target "
                    f"[{lo}, {hi}) are not covered by the baseline full "
                    f"step {baseline.step}'s chunks")

    dense_bytes = sum(d.nbytes for d in chain[-1].dense.values())
    return RangePlan(chain=chain, targets=targets, reads=reads,
                     chunk_bytes=chunk_bytes, dense_bytes=dense_bytes,
                     chunks_total=total, chunks_skipped=skipped,
                     source_layouts=layouts)


def layout_num_hosts(man: mf.Manifest) -> int:
    """Source host count of one chain step, normalized: the explicit
    versioned layout record when present, else derived from the legacy
    ``shards`` map (1 when unsharded)."""
    return int(mf.layout_of(man)["num_hosts"])


def clip_decoded(decoded, lo: int, hi: int):
    """Restrict one decoded chunk ``(idx, vals, aux)`` to global rows in
    ``[lo, hi)``. Indices are sorted ascending (range chunks by
    construction; incremental encoders store sorted global indices), so
    the common all-inside case is a cheap endpoint check and the clip a
    contiguous slice."""
    idx, vals, aux = decoded
    n = len(idx)
    if n == 0 or (idx[0] >= lo and idx[-1] < hi):
        return decoded
    a = int(np.searchsorted(idx, lo, side="left"))
    b = int(np.searchsorted(idx, hi, side="left"))
    idx2 = idx[a:b]
    vals2 = vals[a:b]
    aux2 = {}
    for name, (a_vals, width, a_dt) in aux.items():
        if width <= 0 or a_vals.size == 0:
            aux2[name] = (a_vals, width, a_dt)
        else:
            aux2[name] = (a_vals.reshape(n, width)[a:b].reshape(-1),
                          width, a_dt)
    return idx2, vals2, aux2
