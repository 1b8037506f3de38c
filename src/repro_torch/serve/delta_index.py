"""Read-optimized delta index: per-step touched-row summaries in the manifest.

The serving story (docs/serving.md) needs a subscriber at step S to answer
"what would catching up to step T cost, and which rows move?" WITHOUT
fetching a single chunk header. Chunk records already carry everything
needed — full chunks are range-encoded, incremental chunks now record
compressed ``row_spans`` of their global row indices — so the index is a
pure aggregation stamped into the manifest at commit time:

    delta = {
      "version": 1,
      "tables": {name: {"rows_touched": int,   # Σ chunk n_rows (disjoint)
                         "payload_bytes": int,  # Σ chunk nbytes
                         "spans": [[lo, hi), ...]},  # sorted, disjoint,
                                                     # SUPERSET of touched rows
                 ...},
      "dense_bytes": int,
    }

Two invariants every consumer may rely on (tests/test_delta_index.py):

* **superset** — every row whose bytes the step actually changed lies
  inside some span (span compression only ever widens, never narrows);
* **cost** — summing ``payload_bytes`` over a chain suffix plus the head's
  ``dense_bytes`` equals the range planner's own estimate for replaying
  that suffix (``plan_ranges(suffix).nbytes``).

Legacy manifests (written before this index existed) derive an equivalent
version-0 record lazily from their chunk records — the same pattern as
the manifest's layout record (``manifest.layout_of``) — via :func:`delta_of`, so
old chains plan identically to new ones, just with coarser spans.

Determinism: :func:`build_delta` is a pure function of the (merged) chunk
records, so the coordinator-less sharded commit stays byte-deterministic —
every racing committer stamps the identical index.

This module deliberately imports nothing from ``repro_torch.core`` at module
scope: the core writers (``checkpoint._write``,
``coordinator._assemble_manifest``) import it, and a top-level back-import
would cycle. ``delta_of`` pulls the range planner lazily at call time.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Version of the commit-time index. Version 0 is reserved for records
# derived lazily from legacy manifests (no index stamped).
DELTA_VERSION = 1

# Per-table span budget. Spans beyond the cap merge across the SMALLEST
# gaps first, so the summary stays a tight superset; 64 spans × 2 ints is
# noise next to the chunk records themselves.
MAX_SPANS = 64

# Per-chunk span budget (stamped into ChunkRecord.row_spans by the encode
# jobs). Smaller than MAX_SPANS: a chunk covers at most chunk_rows rows.
MAX_CHUNK_SPANS = 16


def compress_spans(idx: np.ndarray, cap: int = MAX_CHUNK_SPANS
                   ) -> List[List[int]]:
    """Compress sorted ascending global row indices into at most ``cap``
    half-open ``[lo, hi)`` spans. Exact (maximal consecutive runs) when the
    run count fits; otherwise the ``cap - 1`` WIDEST gaps survive as
    separators and everything between them merges — the result is always a
    superset of ``idx`` and never wider than merging forces it to be.
    Deterministic (ties broken by position) so sharded commits that embed
    these spans stay byte-identical across racing committers."""
    n = len(idx)
    if n == 0:
        return []
    breaks = np.flatnonzero(np.diff(idx) > 1)
    starts = np.concatenate(([0], breaks + 1))
    ends = np.concatenate((breaks, [n - 1]))
    spans = [[int(idx[s]), int(idx[e]) + 1] for s, e in zip(starts, ends)]
    return _cap_spans(spans, cap)


def _cap_spans(spans: List[List[int]], cap: int) -> List[List[int]]:
    """Merge sorted disjoint spans down to ``cap`` by closing the smallest
    inter-span gaps (equivalently: keeping the ``cap - 1`` widest gaps)."""
    if cap <= 0 or len(spans) <= cap:
        return spans
    gaps = sorted(((spans[i + 1][0] - spans[i][1], i)
                   for i in range(len(spans) - 1)), reverse=True)
    keep = sorted(i for _, i in gaps[:cap - 1])
    out = []
    lo = spans[0][0]
    prev_end = spans[0][1]
    j = 0
    for i in range(len(spans) - 1):
        if j < len(keep) and keep[j] == i:
            out.append([lo, prev_end])
            lo = spans[i + 1][0]
            j += 1
        prev_end = spans[i + 1][1]
    out.append([lo, prev_end])
    return out


def merge_spans(spans: Sequence[Sequence[int]], cap: int = MAX_SPANS
                ) -> List[List[int]]:
    """Union arbitrary ``[lo, hi)`` spans into a sorted disjoint list,
    then cap it (:func:`_cap_spans`). Empty and inverted spans drop."""
    norm = sorted([int(lo), int(hi)] for lo, hi in spans if lo < hi)
    if not norm:
        return []
    out = [norm[0][:]]
    for lo, hi in norm[1:]:
        if lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return _cap_spans(out, cap)


def build_delta(tables, dense, rows_of: Optional[Dict[str, int]] = None
                ) -> dict:
    """Build the commit-time index from (merged) table/dense records.

    Pure and deterministic: derived solely from chunk records in chunk
    order, table names sorted by the manifest's ``sort_keys`` JSON dump.
    Per chunk the span source is, in preference order, ``row_spans``
    (incremental chunks, compressed at encode time), ``row_range`` (full
    range-encoded chunks — exact), else the whole table (legacy writers;
    the conservative bound)."""
    out_tables: Dict[str, dict] = {}
    for name, rec in tables.items():
        spans: List[Sequence[int]] = []
        rows_touched = 0
        payload = 0
        total_rows = int(rows_of[name]) if rows_of else int(rec.rows)
        for ch in rec.chunks:
            if ch.n_rows == 0:
                continue
            rows_touched += int(ch.n_rows)
            payload += int(ch.nbytes)
            ch_spans = getattr(ch, "row_spans", None)
            if ch_spans:
                spans.extend(ch_spans)
            elif ch.row_range is not None:
                spans.append(ch.row_range)
            else:
                spans.append([0, total_rows])
        out_tables[name] = {
            "rows_touched": rows_touched,
            "payload_bytes": payload,
            "spans": merge_spans(spans),
        }
    return {
        "version": DELTA_VERSION,
        "tables": out_tables,
        "dense_bytes": int(sum(int(d.nbytes) for d in dense.values())),
    }


def delta_of(manifest) -> dict:
    """A manifest's delta index, normalized: the stamped record when
    present, else version 0 derived lazily from chunk records using the
    range planner's conservative per-chunk bounds (exact for range-encoded
    full chunks, writer-shard bounds for sharded incrementals, whole table
    otherwise). Every subscriber-side consumer goes through this so legacy
    chains cost and plan identically to new ones."""
    if getattr(manifest, "delta", None) is not None:
        return manifest.delta
    from repro_torch.core import range_reader as rr  # lazy: avoids core<->serve cycle

    src_n = rr.layout_num_hosts(manifest)
    out_tables: Dict[str, dict] = {}
    for name, rec in manifest.tables.items():
        spans: List[Sequence[int]] = []
        rows_touched = 0
        payload = 0
        for ch in rec.chunks:
            if ch.n_rows == 0:
                continue
            rows_touched += int(ch.n_rows)
            payload += int(ch.nbytes)
            lo, hi, _ = rr.chunk_row_bound(rec, ch, src_n)
            spans.append([lo, hi])
        out_tables[name] = {
            "rows_touched": rows_touched,
            "payload_bytes": payload,
            "spans": merge_spans(spans),
        }
    return {
        "version": 0,
        "tables": out_tables,
        "dense_bytes": int(sum(int(d.nbytes)
                               for d in manifest.dense.values())),
    }


def catchup_cost(chain_suffix: Sequence) -> Dict[str, int]:
    """Cost a catch-up that replays ``chain_suffix`` (the manifests strictly
    after the subscriber's applied step, oldest→newest), from the delta
    index alone — no chunk headers, no range plan. Returns
    ``{"chunk_bytes", "dense_bytes", "nbytes", "rows_touched"}``; matches
    ``plan_ranges(chain_suffix).nbytes`` exactly when every step carries a
    stamped index (the property test pins the tolerance)."""
    chunk_bytes = 0
    rows = 0
    for man in chain_suffix:
        d = delta_of(man)
        for t in d["tables"].values():
            chunk_bytes += int(t["payload_bytes"])
            rows += int(t["rows_touched"])
    dense_bytes = int(delta_of(chain_suffix[-1])["dense_bytes"]) \
        if chain_suffix else 0
    return {
        "chunk_bytes": chunk_bytes,
        "dense_bytes": dense_bytes,
        "nbytes": chunk_bytes + dense_bytes,
        "rows_touched": rows,
    }


def touched_union(chain_suffix: Sequence) -> Dict[str, List[List[int]]]:
    """Per-table union of the suffix's touched-row spans — which rows a
    catch-up may rewrite (superset). What a subscriber uses to size its
    resync copies and what cache-invalidation layers key off."""
    spans: Dict[str, List[Sequence[int]]] = {}
    for man in chain_suffix:
        for name, t in delta_of(man)["tables"].items():
            spans.setdefault(name, []).extend(t["spans"])
    return {name: merge_spans(s) for name, s in spans.items()}
