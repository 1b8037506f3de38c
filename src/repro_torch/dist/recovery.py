"""Partial-recovery supervisor: detect a failed host, replay ONE shard,
in PyTorch.

The failure model (docs/partial_recovery.md): a training job runs N host
processes, each owning a contiguous row-shard of every embedding table
(``row_shard_bounds``). When one host dies — SIGKILL, OOM, machine loss —
its in-memory shard (table rows, optimizer slots, touched bits) is gone,
but the survivors' shards and the job's dense state are intact. Restoring
the WHOLE model from the store costs O(model) bytes and minutes; replaying
only the failed host's shard chain (``CheckNRunManager.restore_part``)
costs O(shard).

Three cooperating pieces:

* **Heartbeats** — host processes publish liveness keys
  (``heartbeats/host_<h>.json``) in the object store itself: the store is
  the one medium every participant already shares (multi-pod launches have
  no common filesystem). :class:`HeartbeatWriter` runs in the host
  process (wired in ``dist.host_proc`` via ``--heartbeat``).
* **Fencing** — before its shard is replayed, the failed host is fenced
  by bumping ``heartbeats/fence_host_<h>.json``. A zombie host (paused,
  not dead) observes the fence epoch on its next beat and exits rather
  than keep writing chunks a recovered replacement now owns. Cooperative,
  like the parent watchdog: it bounds a zombie's damage to one heartbeat
  period.
* **Detection + recovery** — :class:`RecoverySupervisor` combines
  process exit codes (authoritative when the supervisor launched the
  host) with heartbeat staleness (the only signal for hosts on other
  machines), then recovers the shard via ``restore_part`` with automatic
  fallback to a full ``restore()`` on :class:`PartialRecoveryError`.

The train-side splice (overwrite only the recovered rows of a live
``TrainState``, re-fence touched/optimizer state, resume under an
``exact`` or ``cpr`` staleness policy) lives in ``repro_torch.train.loop``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import threading
import time
from typing import Any, Dict, List, Optional

from ..core import manifest as mf
from ..core import range_reader as rr
from ..core.checkpoint import CheckNRunManager, PartialRecoveryError, RestoredState
from ..core.storage import ObjectStore

HEARTBEAT_PREFIX = "heartbeats/"


def heartbeat_key(host: int) -> str:
    return f"{HEARTBEAT_PREFIX}host_{host:04d}.json"


def fence_key(host: int) -> str:
    return f"{HEARTBEAT_PREFIX}fence_host_{host:04d}.json"


def write_heartbeat(store: ObjectStore, host: int, *, epoch: int = 0,
                    step: Optional[int] = None, pid: Optional[int] = None,
                    now: Optional[float] = None) -> None:
    store.put(heartbeat_key(host), json.dumps(
        {"host": host, "epoch": epoch, "step": step,
         "pid": pid if pid is not None else os.getpid(),
         "unix": time.time() if now is None else now}).encode())


def read_heartbeat(store: ObjectStore, host: int) -> Optional[dict]:
    try:
        return json.loads(store.get(heartbeat_key(host)).decode())
    except (KeyError, FileNotFoundError, ValueError):
        return None


def read_fence(store: ObjectStore, host: int) -> int:
    """The host's current fence epoch (0 = never fenced). A writer whose
    own epoch is BELOW this must stop — its shard has been recovered out
    from under it."""
    try:
        return int(json.loads(store.get(fence_key(host)).decode())["epoch"])
    except (KeyError, FileNotFoundError, ValueError, TypeError):
        return 0


def fence_host(store: ObjectStore, host: int) -> int:
    """Bump the host's fence epoch; returns the new epoch (which a
    respawned replacement must heartbeat WITH to outrank the zombie)."""
    epoch = read_fence(store, host) + 1
    store.put(fence_key(host), json.dumps(
        {"epoch": epoch, "unix": time.time()}).encode())
    return epoch


class HeartbeatWriter:
    """Daemon thread publishing one host's liveness key every
    ``interval_s``. Each beat also checks the fence: a beat that observes
    ``fence_epoch > own epoch`` invokes ``on_fenced`` (default
    ``os._exit(4)`` — the same orphan exit code as the parent watchdog,
    and for the same reason: a fenced host must never keep writing to the
    shared store)."""

    def __init__(self, store: ObjectStore, host: int, *,
                 interval_s: float = 0.5, epoch: int = 0,
                 step: Optional[int] = None,
                 on_fenced=None) -> None:
        self.store = store
        self.host = host
        self.interval_s = interval_s
        self.epoch = epoch
        self.step = step
        self.on_fenced = on_fenced if on_fenced is not None \
            else (lambda: os._exit(4))
        self.fenced = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HeartbeatWriter":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"heartbeat-{self.host}")
        self._thread.start()
        return self

    def _beat_once(self) -> None:
        if read_fence(self.store, self.host) > self.epoch:
            self.fenced = True
            self.on_fenced()
            return
        write_heartbeat(self.store, self.host, epoch=self.epoch,
                        step=self.step)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._beat_once()
            except Exception:
                # liveness publishing must never crash the host's real
                # work; a missed beat just looks stale a little sooner
                pass
            if self.fenced:
                return
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


@dataclasses.dataclass
class HostFailure:
    """One detected host failure and the signal that condemned it."""

    host: int
    reason: str                      # "exit-code" | "stale-heartbeat"
    exit_code: Optional[int] = None
    detail: str = ""


class RecoverySupervisor:
    """Training-side failure detector + shard recoverer.

    Detection combines two signals: exit codes of host processes the
    caller launched (a nonzero/None-to-dead transition is authoritative),
    and heartbeat staleness in the store (covers hosts on machines the
    supervisor cannot wait() on). Recovery fences the victim, replays its
    shard chain via ``restore_part``, and falls back to a full
    ``restore()`` on :class:`PartialRecoveryError` — the caller learns
    which path ran from ``extra["recovery"]["kind"]``.
    """

    def __init__(self, store: ObjectStore, num_hosts: int, *,
                 heartbeat_timeout_s: float = 5.0,
                 now_fn=time.time) -> None:
        self.store = store
        self.num_hosts = num_hosts
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.now_fn = now_fn

    # ------------------------------------------------------------ detection
    def detect_failures(self, procs: Optional[Dict[int, Any]] = None,
                        ) -> List[HostFailure]:
        """Condemn failed hosts. ``procs`` maps host → Popen-like (objects
        with ``poll()``); a host process that exited nonzero is condemned
        by exit code. Hosts without a process handle are condemned when
        their heartbeat (if they ever wrote one) is older than
        ``heartbeat_timeout_s``. Exit code 0 — or a fresh heartbeat — is
        health; a host that never heartbeat and has no handle is unknown,
        not failed (condemning silence would flag hosts that simply have
        not booted)."""
        failures: List[HostFailure] = []
        now = self.now_fn()
        for h in range(self.num_hosts):
            p = (procs or {}).get(h)
            if p is not None:
                code = p.poll()
                if code is not None and code != 0:
                    failures.append(HostFailure(
                        host=h, reason="exit-code", exit_code=code,
                        detail=f"host process exited {code}"))
                    continue
                if code == 0 or code is None:
                    continue  # clean exit / still running → healthy
            hb = read_heartbeat(self.store, h)
            if hb is None:
                continue
            # a fenced-out zombie's old beats must not re-condemn a host
            # whose replacement already beats at a higher epoch
            if hb.get("epoch", 0) < read_fence(self.store, h):
                continue
            age = now - float(hb.get("unix", 0.0))
            if age > self.heartbeat_timeout_s:
                failures.append(HostFailure(
                    host=h, reason="stale-heartbeat",
                    detail=f"last heartbeat {age:.1f}s ago "
                           f"(timeout {self.heartbeat_timeout_s}s)"))
        return failures

    def fence(self, host: int) -> int:
        return fence_host(self.store, host)

    def fence_layout(self, num_hosts: int) -> List[int]:
        """Fence EVERY host index up to ``num_hosts`` (when resharding,
        pass ``max(old, new)`` — zombies from the previous layout must not
        keep writing under the new one). Returns the new epochs."""
        return [self.fence(h) for h in range(num_hosts)]

    # ------------------------------------------------------------- recovery
    def recover(self, manager: CheckNRunManager, host: int, *,
                step: Optional[int] = None,
                num_hosts: Optional[int] = None) -> RestoredState:
        """Fence ``host`` and recover its shard from the committed chain.
        Partial (O(shard)) when the shard chain is intact; on
        :class:`PartialRecoveryError` falls back to a full O(model)
        ``restore(on_corruption="fallback")`` — recovery must degrade, not
        fail. ``num_hosts`` recovers onto a NEW layout (the host's shard
        under ``num_hosts`` hosts, regardless of how the chain was
        written — docs/resharding.md); kind is then ``resharded``.
        ``extra["recovery"]`` records kind, the condemned host, the fence
        epoch, source/target layouts, bytes fetched and wall seconds."""
        t0 = time.monotonic()
        before = self.store.counters.snapshot()["bytes_read"]
        epoch = self.fence(host)
        try:
            rs = manager.restore_part(host, step, num_hosts=num_hosts)
            shard = rs.extra.get("shard", {})
            kind = "resharded" if shard.get("resharded") else "partial"
        except PartialRecoveryError as e:
            rs = manager.restore(step, on_corruption="fallback")
            kind = "full"
            manager._count(recoveries_full_total=1,
                           last_recovery_wall_s=time.monotonic() - t0,
                           last_recovery_host=host)
            rs.extra = dict(rs.extra)
            rs.extra["recovery_fallback_reason"] = f"{e.kind}: {e.detail}"
        rs.extra = dict(rs.extra)
        info = {
            "kind": kind, "host": host, "fence_epoch": epoch,
            "bytes_read": self.store.counters.snapshot()["bytes_read"] - before,
            "wall_s": time.monotonic() - t0}
        if kind != "full":
            shard = rs.extra.get("shard", {})
            info["source_hosts"] = shard.get("source_num_hosts")
            info["target_hosts"] = shard.get("num_hosts")
        rs.extra["recovery"] = info
        return rs

    # -------------------------------------------------------------- respawn
    def respawn(self, store_arg: str, spill_dir: str, host: int, *,
                heartbeat_s: Optional[float] = None,
                poll_interval_s: float = 0.02,
                commit_timeout_s: float = 120.0,
                log_path: Optional[str] = None,
                **host_kwargs) -> subprocess.Popen:
        """Relaunch ONE failed host process against the same spill — the
        survivors' durable phase-1 votes still stand, so a respawned
        victim that rewrites its chunks and votes can complete the
        aborted save's quorum by itself (no survivor restarts). The
        replacement heartbeats at the post-fence epoch so the supervisor
        trusts it over any zombie."""
        from . import host_proc

        cmd = host_proc.host_command(
            store_arg, spill_dir, host,
            heartbeat_s=heartbeat_s,
            heartbeat_epoch=read_fence(self.store, host),
            poll_interval_s=poll_interval_s,
            commit_timeout_s=commit_timeout_s,
            **host_kwargs)
        log = open(log_path, "wb") if log_path else subprocess.DEVNULL
        try:
            return subprocess.Popen(cmd, env=host_proc.child_env(),
                                    stdout=log, stderr=subprocess.STDOUT)
        finally:
            if log_path:
                log.close()

    def respawn_resharded(self, store_arg: str, spill_dir: str,
                          new_num_hosts: int, *,
                          heartbeat_s: Optional[float] = None,
                          poll_interval_s: float = 0.02,
                          commit_timeout_s: float = 120.0,
                          log_dir: Optional[str] = None,
                          **host_kwargs) -> Dict[int, subprocess.Popen]:
        """Relaunch the WHOLE job at a new host count against the same
        spill (docs/resharding.md): the spill's full-table arrays are
        layout-independent (each host mmaps only its shard's rows), so an
        aborted N-host save completes as an N±k-host save. Steps taken,
        in order:

        1. refuse if the spill's step already committed — nothing to
           complete; a fresh run should ``restore_part(..., num_hosts=)``
           under the new layout instead;
        2. fence every host of BOTH layouts (``max(old, new)``): zombies
           from the old incarnation must not write or vote under the new
           one;
        3. purge the aborted attempt's durable votes — an old-layout part
           manifest would otherwise count toward the new quorum with
           wrong-shard contents (old CHUNK debris is harmless: it is
           either overwritten key-for-key or left unreferenced by the
           committed manifest);
        4. rewrite the spill's recorded layout and launch all
           ``new_num_hosts`` replacements, each heartbeating at its
           post-fence epoch.
        """
        from . import host_proc

        step, old_n, _, _ = host_proc.load_commit(spill_dir)
        if self.store.exists(mf.manifest_key(step)):
            raise RuntimeError(
                f"step {step} is already committed; reshard by restoring "
                f"under the new layout (restore_part(..., num_hosts=)) "
                f"instead of respawning the save")
        self.fence_layout(max(old_n, new_num_hosts))
        for key in list(self.store.list(mf.part_prefix(step))):
            self.store.delete(key)
        host_proc.rewrite_spill_layout(spill_dir, new_num_hosts)
        self.num_hosts = new_num_hosts
        procs: Dict[int, subprocess.Popen] = {}
        for h in range(new_num_hosts):
            cmd = host_proc.host_command(
                store_arg, spill_dir, h,
                heartbeat_s=heartbeat_s,
                heartbeat_epoch=read_fence(self.store, h),
                poll_interval_s=poll_interval_s,
                commit_timeout_s=commit_timeout_s,
                **host_kwargs)
            log_path = (os.path.join(log_dir, f"host_{h}.log")
                        if log_dir else None)
            log = open(log_path, "wb") if log_path else subprocess.DEVNULL
            try:
                procs[h] = subprocess.Popen(cmd, env=host_proc.child_env(),
                                            stdout=log,
                                            stderr=subprocess.STDOUT)
            finally:
                if log_path:
                    log.close()
        return procs


def shard_nbytes(store: ObjectStore, host: int, step: int,
                 num_hosts: Optional[int] = None) -> int:
    """Total payload bytes a partial recovery of ``host`` at ``step``
    should fetch: the range plan for the host's target shard over the
    whole recovery chain plus the final step's (global) dense blobs — the
    yardstick for the "recovery bytes ≈ shard size" acceptance bound.

    The target layout comes from the manifest's recorded layout (NOT from
    caller config — a drill must report honest bytes after a
    ``num_hosts`` change); pass ``num_hosts`` to cost a resharded read
    onto a different layout."""
    chain = mf.recovery_chain(store, step)
    final = chain[-1]
    tgt = num_hosts if num_hosts is not None else rr.layout_num_hosts(final)
    targets = rr.shard_targets(final.tables, host, tgt)
    return rr.plan_ranges(chain, targets).nbytes
