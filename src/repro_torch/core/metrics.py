"""Operational metrics for the checkpoint manager and its store.

``CheckNRunManager.metrics()`` snapshots a :class:`ManagerMetrics` —
save/restore outcomes, last-success recency, bytes moved, GC reclaim
counts, pipeline occupancy — merged with the store's logical counters and
(for remote stores) the transport's wire-level retry stats. ``ckpt
emit-metrics`` renders either a manager-less store view or this snapshot
as a Prometheus textfile (node_exporter textfile-collector format), so a
training job's checkpoint health alerts on the same dashboards as its
loss curves: the paper's operating target — checkpoints you can trust at
restore time — needs "age of last good checkpoint" visible BEFORE the
restore that discovers it was bad.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

from . import manifest as mf
from .integrity import CORRUPT_PREFIX, quarantined_steps
from .storage import ObjectStore

PROM_PREFIX = "cnr"


@dataclasses.dataclass
class ManagerMetrics:
    """One consistent snapshot of a manager's lifetime counters.

    All ``*_total`` fields are monotonic within the manager's lifetime;
    gauges (``last_*``, ``occupancy``) reflect the most recent event.
    ``store`` / ``remote`` carry the store's logical byte/op counters and
    the remote transport's wire stats (empty dict when not remote).
    """

    # saves
    saves_total: int = 0
    saves_ok: int = 0
    saves_cancelled: int = 0
    saves_failed: int = 0
    save_bytes_total: int = 0
    last_success_step: Optional[int] = None
    last_success_unix: Optional[float] = None
    last_save_kind: Optional[str] = None
    # restores
    restores_total: int = 0
    restore_bytes_total: int = 0
    restore_fallbacks_total: int = 0
    corruption_errors_total: int = 0
    last_restore_step: Optional[int] = None
    # partial recovery (docs/partial_recovery.md): shard-only replays and
    # their full-restore fallbacks, counted by kind so dashboards can tell
    # an O(shard) recovery from an O(model) one; ``resharded`` counts
    # range reads that crossed a num_hosts change (docs/resharding.md) —
    # mutually exclusive with ``partial``
    recoveries_partial_total: int = 0
    recoveries_full_total: int = 0
    recoveries_resharded_total: int = 0
    recovery_rows_replayed_total: int = 0
    last_recovery_wall_s: Optional[float] = None
    last_recovery_host: Optional[int] = None
    # source → target host counts of the most recent shard recovery, so
    # elastic events (N±k restarts) are visible on dashboards
    last_recovery_source_hosts: Optional[int] = None
    last_recovery_target_hosts: Optional[int] = None
    # GC / retention
    retention_steps_deleted_total: int = 0
    gc_steps_reclaimed_total: int = 0
    gc_keys_reclaimed_total: int = 0
    # pipeline occupancy of the most recent save / restore (stage -> [0,1])
    save_occupancy: Dict[str, float] = dataclasses.field(default_factory=dict)
    restore_occupancy: Dict[str, float] = dataclasses.field(default_factory=dict)
    # store-level counters (StoreCounters.snapshot) and remote wire stats
    store: Dict[str, int] = dataclasses.field(default_factory=dict)
    remote: Dict[str, int] = dataclasses.field(default_factory=dict)
    captured_unix: float = 0.0

    @property
    def last_success_age_s(self) -> Optional[float]:
        if self.last_success_unix is None:
            return None
        return max(0.0, self.captured_unix - self.last_success_unix)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["last_success_age_s"] = self.last_success_age_s
        return d

    def to_prometheus(self, prefix: str = PROM_PREFIX) -> str:
        return render_prometheus(self.to_dict(), prefix=prefix)


def _prom_escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


_HELP = {
    "saves_total": "Checkpoint save attempts by outcome.",
    "save_bytes_total": "Payload bytes committed by successful saves.",
    "last_success_step": "Step of the last committed checkpoint.",
    "last_success_age_s": "Seconds since the last committed checkpoint.",
    "restores_total": "Completed restores.",
    "restore_bytes_total": "Payload bytes fetched by restores.",
    "restore_fallbacks_total":
        "Restores that replanned onto an older chain after corruption.",
    "corruption_errors_total":
        "Chunk integrity failures observed during decode.",
    "recoveries_total":
        "Host-loss recoveries by kind (partial shard replay, resharded "
        "range read across a layout change, or full-restore fallback).",
    "last_recovery_source_hosts":
        "Source layout host count of the most recent shard recovery.",
    "last_recovery_target_hosts":
        "Target layout host count of the most recent shard recovery.",
    "recovery_rows_replayed_total":
        "Embedding rows replayed by partial (shard-only) recoveries.",
    "last_recovery_wall_s": "Wall seconds of the most recent recovery.",
    "last_recovery_host": "Host index of the most recent recovery.",
    "retention_steps_deleted_total":
        "Committed steps deleted by the retention policy.",
    "gc_steps_reclaimed_total": "Aborted steps garbage-collected.",
    "gc_keys_reclaimed_total": "Blobs deleted by aborted-save GC.",
    "pipeline_occupancy":
        "Per-stage busy fraction of the most recent save/restore pipeline.",
    "store_bytes_written_total": "Logical bytes written to the store.",
    "store_bytes_read_total": "Logical bytes read from the store.",
    "store_ops_total": "Store operations by kind.",
    "remote_requests_total": "Remote transport request attempts.",
    "remote_retries_total": "Remote transport retries.",
    "remote_bytes_sent_total":
        "Wire bytes sent including retransmissions.",
    "remote_bytes_received_total": "Wire bytes received.",
    "remote_verify_gets_total": "Read-back verification GETs.",
    "steps_committed": "Committed checkpoint steps in the store.",
    "steps_aborted": "Aborted (uncommitted) steps with debris.",
    "steps_quarantined": "Steps parked under corrupt/.",
    "latest_step": "Newest committed step.",
    "latest_step_age_s": "Seconds since the newest committed step.",
    "latest_step_nbytes": "Payload bytes of the newest committed step.",
    # serving subscriber (docs/serving.md) — freshness and bytes-per-
    # refresh are the two alertable signals: a healthy replica's lag
    # stays near 0 and its refresh bytes track touched rows, not model
    # size; a replica in "held" is serving intentionally stale data
    "serve_state": "Subscriber state (one-hot by state label).",
    "serve_applied_step": "Step the replica currently serves.",
    "serve_head_step": "Newest committed step seen by the subscriber.",
    "serve_lag_steps":
        "Committed steps the served version is behind the head.",
    "serve_polls_total": "Subscriber poll iterations.",
    "serve_applied_steps_total": "Refreshes published to readers.",
    "serve_refresh_bytes_total":
        "Payload bytes fetched by catch-up refreshes.",
    "serve_refresh_rows_total": "Embedding rows replayed by refreshes.",
    "serve_refreshes_total":
        "Published refreshes by kind (incremental delta apply vs full "
        "resync).",
    "serve_holds_total":
        "Refreshes aborted on chunk corruption (replica held last good "
        "version).",
    "serve_errors_total": "Transient poll/refresh failures.",
    "serve_manifest_cache_total":
        "Validated manifest-cache lookups by outcome.",
    "serve_last_refresh_wall_s": "Wall seconds of the last refresh.",
    "serve_lookups_total": "Pinned lookup batches served.",
    "serve_rows_read_total": "Embedding rows returned to lookups.",
    "serve_consecutive_failures": "Consecutive failed polls.",
}


def render_prometheus(values: dict, prefix: str = PROM_PREFIX) -> str:
    """Render a metrics dict as Prometheus text exposition. Dict-valued
    entries become labelled series; None values are skipped (absent gauge
    beats a fake zero)."""
    lines = []

    def emit(name: str, value, labels: Optional[Dict[str, str]] = None,
             mtype: str = "gauge"):
        if value is None:
            return
        full = f"{prefix}_{name}"
        if not any(line.startswith(f"# HELP {full} ") for line in lines):
            help_txt = _HELP.get(name, name.replace("_", " "))
            lines.append(f"# HELP {full} {help_txt}")
            lines.append(f"# TYPE {full} {mtype}")
        lab = ""
        if labels:
            lab = ("{" + ",".join(f'{k}="{_prom_escape(str(v))}"'
                                  for k, v in sorted(labels.items())) + "}")
        if isinstance(value, bool):
            value = int(value)
        lines.append(f"{full}{lab} {value}")

    # saves by outcome as one labelled counter family
    if "saves_total" in values:
        emit("saves_total", values.get("saves_ok"),
             {"outcome": "ok"}, "counter")
        emit("saves_total", values.get("saves_cancelled"),
             {"outcome": "cancelled"}, "counter")
        emit("saves_total", values.get("saves_failed"),
             {"outcome": "failed"}, "counter")
    # host-loss recoveries by kind as one labelled counter family
    if "recoveries_partial_total" in values:
        emit("recoveries_total", values.get("recoveries_partial_total"),
             {"kind": "partial"}, "counter")
        emit("recoveries_total", values.get("recoveries_full_total"),
             {"kind": "full"}, "counter")
        emit("recoveries_total", values.get("recoveries_resharded_total"),
             {"kind": "resharded"}, "counter")
    for name in ("save_bytes_total", "restores_total", "restore_bytes_total",
                 "restore_fallbacks_total", "corruption_errors_total",
                 "recovery_rows_replayed_total",
                 "retention_steps_deleted_total", "gc_steps_reclaimed_total",
                 "gc_keys_reclaimed_total"):
        if name in values:
            emit(name, values[name], mtype="counter")
    for name in ("last_success_step", "last_success_age_s",
                 "last_restore_step", "last_recovery_wall_s",
                 "last_recovery_host", "last_recovery_source_hosts",
                 "last_recovery_target_hosts",
                 "steps_committed", "steps_aborted",
                 "steps_quarantined", "latest_step", "latest_step_age_s",
                 "latest_step_nbytes"):
        if name in values:
            emit(name, values[name])
    for phase in ("save", "restore"):
        for stage, frac in (values.get(f"{phase}_occupancy") or {}).items():
            emit("pipeline_occupancy", frac,
                 {"phase": phase, "stage": stage})
    store = values.get("store") or {}
    if store:
        emit("store_bytes_written_total", store.get("bytes_written"),
             mtype="counter")
        emit("store_bytes_read_total", store.get("bytes_read"),
             mtype="counter")
        for op in ("put", "get", "delete"):
            emit("store_ops_total", store.get(f"{op}_ops"),
                 {"op": op}, "counter")
    remote = values.get("remote") or {}
    for k in ("requests", "retries", "bytes_sent", "bytes_received",
              "verify_gets"):
        if k in remote:
            emit(f"remote_{k}_total", remote[k], mtype="counter")
    serve = values.get("serve") or {}
    if serve:
        if serve.get("state") is not None:
            for st in ("init", "idle", "live", "held", "retrying"):
                emit("serve_state", int(serve["state"] == st),
                     {"state": st})
        for name in ("applied_step", "head_step", "lag_steps",
                     "consecutive_failures", "last_refresh_wall_s"):
            if name in serve:
                emit(f"serve_{name}", serve[name])
        emit("serve_refreshes_total",
             serve.get("incremental_refreshes_total"),
             {"kind": "incremental"}, "counter")
        emit("serve_refreshes_total", serve.get("full_syncs_total"),
             {"kind": "full"}, "counter")
        emit("serve_manifest_cache_total",
             serve.get("manifest_cache_hits_total"),
             {"outcome": "hit"}, "counter")
        emit("serve_manifest_cache_total",
             serve.get("manifest_cache_misses_total"),
             {"outcome": "miss"}, "counter")
        for name in ("polls_total", "applied_steps_total",
                     "refresh_bytes_total", "refresh_rows_total",
                     "holds_total", "errors_total", "lookups_total",
                     "rows_read_total"):
            if name in serve:
                emit(f"serve_{name}", serve[name], mtype="counter")
    return "\n".join(lines) + "\n" if lines else ""


def write_textfile(text: str, path: str) -> None:
    """Atomic textfile write (tmp + rename) — node_exporter's textfile
    collector reads these unlocked, so a torn write would surface as a
    parse error and drop the whole file's metrics."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def store_metrics(store: ObjectStore, now: Optional[float] = None) -> dict:
    """Manager-less store health view for ``ckpt emit-metrics`` against an
    arbitrary store URI: committed/aborted/quarantined step counts, newest
    step recency and size, plus the store's own counters (which, for a
    fresh CLI process, cover only this invocation's traffic)."""
    now = time.time() if now is None else now
    steps = mf.list_steps(store)
    out: dict = {
        "steps_committed": len(steps),
        "steps_aborted": len(mf.aborted_steps(store)),
        "steps_quarantined": len(quarantined_steps(store)),
        "latest_step": steps[-1] if steps else None,
        "latest_step_age_s": None,
        "latest_step_nbytes": None,
        "store": store.counters.snapshot(),
        "captured_unix": now,
    }
    if steps:
        try:
            man = mf.load(store, steps[-1])
            out["latest_step_age_s"] = max(0.0, now - man.created_unix)
            out["latest_step_nbytes"] = man.nbytes_total
        except (ValueError, KeyError, FileNotFoundError):
            pass
    stats = getattr(store, "stats", None)
    if stats is not None and hasattr(stats, "snapshot"):
        out["remote"] = stats.snapshot()
    return out
