"""Real-process host runner for sharded multi-host checkpointing (§3.4),
in PyTorch.

One OS process per host: the launching manager spills the snapshot to a
scratch directory (one ``.npy`` per array), then spawns
``python -m repro_torch.dist.host_proc`` once per host over a shared store
— either a :class:`~repro_torch.core.storage.LocalFSStore` root
(process-safe: atomic ``os.replace`` puts + directory fsync) or, for
multi-pod launches with NO shared filesystem, a remote object-store URI
(``http://host:port`` → :class:`~repro_torch.core.remote_store.
RemoteObjectStore`; chunks, votes and the phase-2 commit all run over
remote keys). Each host process

  1. memory-maps the spilled arrays and runs
     :class:`~repro_torch.dist.shard_writer.HostShardWriter` over its
     row-shards on the device the spilled config names: on a card its
     chunks are quantized and hashed by the ``quant_pack`` and
     ``chunk_hash`` kernels in this process (a host whose config says
     ``cpu`` runs their plain versions and never initialises CUDA)
     — the mmap means a host only ever faults in ITS shard's rows, so the
     process touches O(shard) bytes, not O(snapshot) (each host "snapshots"
     only its addressable rows);
  2. publishes its part manifest (the phase-1 vote) exactly as the
     thread-simulated path does — the byte format has one implementation;
  3. runs phase 2 itself (:func:`~repro_torch.dist.shard_writer.
     poll_votes_and_commit`): polls the parts namespace, and the LAST host
     to observe all votes merges the parts and commits the global
     manifest. No coordinator rank exists; the commit is idempotent and
     byte-deterministic, so racing committers are harmless.

The store is the single source of truth: the launcher declares the save
committed iff the global manifest exists, whatever the child exit codes
say (a SIGKILLed host does not un-commit a manifest a peer already wrote).

Exit codes: 0 — committed or observed the committed manifest;
3 — quorum never formed before ``--commit-timeout`` (a peer died before
voting); 4 — orphaned (``--watch-parent`` saw the launcher die and bailed
out rather than keep writing to the shared store, where an orphan could
otherwise commit a step the restarted trainer no longer expects or race a
retry on the same chunk keys); 5 — commit race detected (a DIFFERENT
manifest exists for the step: the byte-determinism invariant was violated
— the launcher treats this as fatal even though a manifest exists);
anything else — crashed.

Spill layout (written by :func:`write_spill`, read by :func:`load_spill`):

  meta.json      step + array directory ({file, kind, name, aux})
  arr_<i>.npy    one array per entry (tables, row aux, dense, masks)
  config.json    CheckpointConfig as a dict
  commit.json    step / num_hosts / verify_chunks + CommitContext

and each host process leaves ``host_<h>.stats.json`` there when it ends
(:func:`load_host_stats`): its kernel launch counts (counters are per
process, so the launcher cannot see them otherwise), the wall-clock
instants it finished importing, was ready to write (spill mapped, store
open, on a card the CUDA context made and the kernel library loaded) and
was done, its writer's pipeline stats and, over a remote store, its wire
counters.

``--fault`` (tests only) SIGKILLs THIS process — a real ``kill -9``, not
an exception — at a chosen protocol point: ``mid_chunks[:N]`` (after N
durable chunk puts), ``before_vote`` (at the part-manifest put),
``after_vote`` (vote durable, phase 2 never entered), ``mid_merge``
(quorum observed, parts merged, killed at the manifest put itself).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..core import manifest as mf
from ..core.coordinator import CommitContext, build_manifest
from ..core.storage import ObjectStore

SPILL_META = "meta.json"
SPILL_CONFIG = "config.json"
SPILL_COMMIT = "commit.json"


def stats_path(spill_dir: str, host: int) -> str:
    return os.path.join(spill_dir, f"host_{host:04d}.stats.json")


class MultiprocessSaveError(RuntimeError):
    """A multiprocess sharded save did not commit — carries each host
    process's exit status (and log tails as exception notes)."""


# ---------------------------------------------------------------- spill I/O
def write_spill(spill_dir: str, snap, cum: Dict[str, np.ndarray],
                unc: Dict[str, np.ndarray], config, step: int,
                num_hosts: int, ctx: CommitContext,
                verify_chunks: bool) -> None:
    """Serialize one save attempt for host processes: snapshot arrays as
    individual ``.npy`` files (mmap-loadable), the manager config, and the
    commit context every potential committer must share byte-identically."""
    os.makedirs(spill_dir, exist_ok=True)
    entries: List[dict] = []

    def add(kind: str, name: str, arr, aux: Optional[str] = None) -> None:
        fn = f"arr_{len(entries):04d}.npy"
        np.save(os.path.join(spill_dir, fn), np.ascontiguousarray(arr))
        entries.append({"file": fn, "kind": kind, "name": name, "aux": aux})

    for name, tab in snap.tables.items():
        add("table", name, tab)
    for name, d in snap.row_state.items():
        for aux, arr in d.items():
            add("row_state", name, arr, aux=aux)
    for name, arr in snap.dense.items():
        add("dense", name, arr)
    for name, arr in cum.items():
        add("cum", name, arr)
    for name, arr in unc.items():
        add("unc", name, arr)

    with open(os.path.join(spill_dir, SPILL_META), "w") as f:
        json.dump({"step": snap.step, "arrays": entries}, f)
    with open(os.path.join(spill_dir, SPILL_CONFIG), "w") as f:
        json.dump(dataclasses.asdict(config), f)
    with open(os.path.join(spill_dir, SPILL_COMMIT), "w") as f:
        json.dump({"step": step, "num_hosts": num_hosts,
                   "verify_chunks": verify_chunks,
                   "ctx": ctx.to_dict()}, f)


def load_spill(spill_dir: str):
    """Rebuild (snapshot, cum, unc) from a spill. Arrays are memory-mapped
    read-only: slicing ``tab[idx]`` inside the writer faults in only the
    host's shard rows, so a host process reads O(shard) of the snapshot."""
    from ..core.snapshot import Snapshot

    with open(os.path.join(spill_dir, SPILL_META)) as f:
        meta = json.load(f)
    tables: Dict[str, np.ndarray] = {}
    row_state: Dict[str, Dict[str, np.ndarray]] = {}
    dense: Dict[str, np.ndarray] = {}
    cum: Dict[str, np.ndarray] = {}
    unc: Dict[str, np.ndarray] = {}
    for e in meta["arrays"]:
        arr = np.load(os.path.join(spill_dir, e["file"]), mmap_mode="r")
        kind, name = e["kind"], e["name"]
        if kind == "table":
            tables[name] = arr
        elif kind == "row_state":
            row_state.setdefault(name, {})[e["aux"]] = arr
        elif kind == "dense":
            dense[name] = arr
        elif kind == "cum":
            # np.array (not asarray — that returns a memmap VIEW): the
            # masks must not stay backed by spill files the launcher may
            # delete; they are tiny, copy them
            cum[name] = np.array(arr)
        elif kind == "unc":
            unc[name] = np.array(arr)
    for name in tables:
        row_state.setdefault(name, {})
    snap = Snapshot(step=meta["step"], tables=tables, row_state=row_state,
                    touched={}, dense=dense, extra={})
    return snap, cum, unc


def load_commit(spill_dir: str):
    with open(os.path.join(spill_dir, SPILL_COMMIT)) as f:
        d = json.load(f)
    return (d["step"], d["num_hosts"], d["verify_chunks"],
            CommitContext.from_dict(d["ctx"]))


def load_host_stats(spill_dir: str, host: int) -> Optional[dict]:
    """The stats a host process left in the spill, or None (it was killed
    before it could write them)."""
    try:
        with open(stats_path(spill_dir, host)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def load_config(spill_dir: str):
    from ..core.checkpoint import CheckpointConfig
    from ..core.quantize import QuantConfig

    with open(os.path.join(spill_dir, SPILL_CONFIG)) as f:
        d = json.load(f)
    q = d.pop("quant", None)
    return CheckpointConfig(quant=QuantConfig(**q) if q else None, **d)


def rewrite_spill_layout(spill_dir: str, num_hosts: int) -> None:
    """Re-key a spill to a new host count (elastic respawn —
    ``RecoverySupervisor.respawn_resharded``). The snapshot arrays are
    full tables and layout-independent (each host mmap-slices only its
    own writer shard), so only the two records that name the layout —
    the manager config and the shared commit context's quorum size —
    need rewriting. Must happen before any new-layout host launches."""
    for fn in (SPILL_CONFIG, SPILL_COMMIT):
        path = os.path.join(spill_dir, fn)
        with open(path) as f:
            d = json.load(f)
        d["num_hosts"] = int(num_hosts)
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(d, f)
        os.replace(tmp, path)


# ------------------------------------------------------------ process launch
def child_env() -> Dict[str, str]:
    """Environment for a host process: ensures the running ``repro_torch``
    tree is importable regardless of the launcher's own sys.path setup."""
    src = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    prior = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = src + (os.pathsep + prior if prior else "")
    return env


def host_command(store: str, spill_dir: str, host: int, *,
                 fault: Optional[str] = None,
                 race_commit: bool = False,
                 dump_manifest: Optional[str] = None,
                 poll_interval_s: Optional[float] = None,
                 commit_timeout_s: Optional[float] = None,
                 deadline_unix: Optional[float] = None,
                 watch_parent: bool = False,
                 net_fault: Optional[str] = None,
                 batch_fsync: bool = False,
                 heartbeat_s: Optional[float] = None,
                 heartbeat_epoch: Optional[int] = None) -> List[str]:
    """``store`` is a LocalFSStore root path OR a remote store URI
    (``http://host:port``) — :func:`~repro_torch.core.remote_store.make_store`
    resolves either spelling inside the child."""
    cmd = [sys.executable, "-m", "repro_torch.dist.host_proc",
           "--store", store, "--spill", spill_dir, "--host", str(host)]
    if watch_parent:
        cmd += ["--watch-parent", str(os.getpid())]
    if heartbeat_s is not None:
        cmd += ["--heartbeat", str(heartbeat_s)]
    if heartbeat_epoch is not None:
        cmd += ["--heartbeat-epoch", str(heartbeat_epoch)]
    if net_fault:
        cmd += ["--net-fault", net_fault]
    if batch_fsync:
        cmd += ["--batch-fsync"]
    if fault:
        cmd += ["--fault", fault]
    if race_commit:
        cmd += ["--race-commit"]
    if dump_manifest:
        cmd += ["--dump-manifest", dump_manifest]
    if poll_interval_s is not None:
        cmd += ["--poll-interval", str(poll_interval_s)]
    if commit_timeout_s is not None:
        cmd += ["--commit-timeout", str(commit_timeout_s)]
    if deadline_unix is not None:
        cmd += ["--deadline-unix", str(deadline_unix)]
    return cmd


def _start_parent_watchdog(parent_pid: int) -> None:
    """Exit (code 4) as soon as the launching process dies — a reparented
    host must not keep writing: within ``commit_timeout`` an orphan set
    could still commit the step, or race a restarted trainer's retry on
    the very same chunk keys. ``parent_pid`` is the LAUNCHER's pid passed
    on the command line, not ``os.getppid()`` sampled at startup — the
    launcher can die during this interpreter's multi-second boot, and a
    child that samples after reparenting would watch the reaper forever."""
    def watch() -> None:
        while True:
            if os.getppid() != parent_pid:
                os._exit(4)
            time.sleep(0.5)

    threading.Thread(target=watch, daemon=True,
                     name="parent-watchdog").start()


# ------------------------------------------------------- fault injection
class _KillSwitchStore(ObjectStore):
    """Test-only: SIGKILLs this process — abrupt, no cleanup, exactly an
    external ``kill -9`` — when the configured protocol point is hit."""

    def __init__(self, inner: ObjectStore, fault: str, step: int,
                 host: int) -> None:
        super().__init__()
        self.inner = inner
        self.counters = inner.counters
        self.fault = fault
        self.step = step
        self.host = host
        self._chunk_puts = 0

    @staticmethod
    def _die() -> None:
        os.kill(os.getpid(), signal.SIGKILL)

    def put(self, key: str, data: bytes) -> None:
        f = self.fault
        if f.startswith("mid_chunks"):
            n = int(f.split(":", 1)[1]) if ":" in f else 0
            if key.startswith(mf.chunk_host_prefix(self.step, self.host)):
                if self._chunk_puts >= n:
                    self._die()
                self._chunk_puts += 1
        elif f == "before_vote" and key == mf.part_key(self.step, self.host):
            self._die()
        elif f == "mid_merge" and key == mf.manifest_key(self.step):
            # quorum observed, parts verified and merged — the put that
            # WOULD be the commit point never lands
            self._die()
        self.inner.put(key, data)

    def get(self, key: str) -> bytes:
        return self.inner.get(key)

    def delete(self, key: str) -> None:
        self.inner.delete(key)

    def list(self, prefix: str = ""):
        return self.inner.list(prefix)

    def exists(self, key: str) -> bool:
        return self.inner.exists(key)

    def size(self, key: str) -> int:
        return self.inner.size(key)


# ------------------------------------------------------------------ runner
def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--store", default=None,
                    help="store spelling: LocalFSStore root path, or a "
                         "remote URI (http://host:port) for multi-pod "
                         "runs with no shared filesystem")
    ap.add_argument("--root", default=None,
                    help="alias for --store (LocalFSStore root)")
    ap.add_argument("--spill", required=True, help="spill directory")
    ap.add_argument("--host", type=int, required=True)
    ap.add_argument("--net-fault", default=None,
                    help="test-only seeded network fault spec "
                         "(FaultSpec k=v,k=v) injected under a remote "
                         "store's transport")
    ap.add_argument("--batch-fsync", action="store_true",
                    help="LocalFSStore: defer chunk dirent fsyncs to the "
                         "pre-vote flush (same crash-safety point)")
    ap.add_argument("--poll-interval", type=float, default=0.02)
    ap.add_argument("--commit-timeout", type=float, default=120.0)
    ap.add_argument("--deadline-unix", type=float, default=None,
                    help="ABSOLUTE wall-clock deadline (unix epoch) for "
                         "this host's write pipeline — absolute so the "
                         "multi-second interpreter/torch boot eats INTO the "
                         "budget instead of silently extending it past the "
                         "launcher's (CheckpointConfig.write_deadline_s)")
    ap.add_argument("--watch-parent", type=int, default=None,
                    metavar="LAUNCHER_PID",
                    help="exit(4) when no longer a child of this pid "
                         "(orphan fencing: never outlive the manager)")
    ap.add_argument("--heartbeat", type=float, default=None,
                    metavar="SECONDS",
                    help="publish a liveness key (heartbeats/host_<h>.json) "
                         "in the store at this period; the recovery "
                         "supervisor reads these to condemn hosts it "
                         "cannot wait() on (docs/partial_recovery.md)")
    ap.add_argument("--heartbeat-epoch", type=int, default=0,
                    help="fence epoch this host's heartbeats carry — a "
                         "respawned replacement beats at the post-fence "
                         "epoch so the supervisor trusts it over a zombie")
    ap.add_argument("--fault", default=None,
                    help="test-only SIGKILL point: mid_chunks[:N] | "
                         "before_vote | after_vote | mid_merge")
    ap.add_argument("--race-commit", action="store_true",
                    help="test-only: always take the committer path once "
                         "the quorum is durable (exercises racing commits)")
    ap.add_argument("--dump-manifest", default=None,
                    help="test-only: write the manifest bytes this host "
                         "would commit to this path (with --race-commit)")
    args = ap.parse_args(argv)
    main_unix = time.time()

    if args.watch_parent is not None:
        _start_parent_watchdog(args.watch_parent)

    from ..core.checkpoint import CheckNRunManager
    from ..core.quantize import QuantConfig
    from .shard_writer import (
        HostShardWriter,
        await_quorum,
        poll_votes_and_commit,
    )

    step, num_hosts, verify_chunks, ctx = load_commit(args.spill)
    config = load_config(args.spill)
    snap, cum, unc = load_spill(args.spill)
    assert snap.step == step, (snap.step, step)

    from ..core.remote_store import (FaultSpec, RemoteObjectStore,
                                     RemoteVerifyError, make_store,
                                     wrap_faulty)

    uri = args.store or args.root
    if not uri:
        ap.error("one of --store / --root is required")
    store: ObjectStore = make_store(uri, batch_fsync=args.batch_fsync)
    if args.net_fault:
        if not isinstance(store, RemoteObjectStore):
            ap.error("--net-fault needs a remote store URI")
        wrap_faulty(store, FaultSpec.parse(args.net_fault))
    heartbeat = None
    if args.heartbeat is not None:
        # beats go through the REAL store (not the kill-switch wrapper):
        # liveness keys never match a fault point, and a SIGKILLed host's
        # beats stop with the process — which is exactly the signal
        from .recovery import HeartbeatWriter

        heartbeat = HeartbeatWriter(store, args.host,
                                    interval_s=args.heartbeat,
                                    epoch=args.heartbeat_epoch,
                                    step=step)
        # the first beat lands before this host's first chunk put, so even
        # a host killed at that put has published its liveness (this
        # process reaches the put sooner than a thread's first beat may)
        heartbeat._beat_once()
        heartbeat.start()
    if args.fault:
        store = _KillSwitchStore(store, args.fault, step, args.host)

    qcfg = QuantConfig(**ctx.quant) if ctx.quant else None
    deadline = (time.monotonic() + (args.deadline_unix - time.time())
                if args.deadline_unix is not None else None)
    mgr = CheckNRunManager(store, config)  # the encoder collaborator
    if mgr.device.type == "cuda":
        # make the context and load the kernels before the clock starts on
        # the writes (no fallback: a library that fails to build raises)
        import torch

        from ..kernels.build import library

        torch.cuda.init()
        library()
    ready_unix = time.time()
    writer = None
    try:
        writer = HostShardWriter(args.host, num_hosts, store, mgr,
                                 deadline=deadline)
        writer.write_part(snap, ctx.kind, qcfg, cum, unc)
        if args.fault == "after_vote":
            _KillSwitchStore._die()

        if args.race_commit:
            # deterministic race (tests): skip the manifest-exists fast
            # path, build the manifest this host would commit (dump it for
            # byte-identity asserts), then commit — every such host takes
            # the committer path
            if await_quorum(store, step, num_hosts,
                            poll_interval_s=args.poll_interval,
                            timeout_s=args.commit_timeout,
                            observe_commit=False) != "quorum":
                return 3
            man = build_manifest(store, step, num_hosts, ctx, verify_chunks)
            if args.dump_manifest:
                with open(args.dump_manifest, "wb") as f:
                    f.write(man.to_json().encode())
            if args.fault == "mid_merge":  # without the store wrapper path
                _KillSwitchStore._die()
            try:
                mf.commit_once(store, man)
            except (mf.CommitRaceError, RemoteVerifyError) as e:
                # RemoteVerifyError here means the manifest's write-through
                # readback saw DIFFERENT bytes — a racing committer with
                # divergent output, the same invariant violation
                print(f"host {args.host}: COMMIT RACE: {e}", flush=True)
                return 5
            return 0

        try:
            outcome = poll_votes_and_commit(
                store, step, num_hosts, ctx, verify_chunks=verify_chunks,
                poll_interval_s=args.poll_interval,
                timeout_s=args.commit_timeout,
                hard_deadline=deadline)
        except (mf.CommitRaceError, RemoteVerifyError) as e:
            # never report success over a divergent manifest — the
            # launcher keys fatality off this exit code, since bare
            # manifest existence would look like a committed save
            # (RemoteVerifyError: the remote write-through readback saw
            # diverging manifest bytes — same invariant violation)
            print(f"host {args.host}: COMMIT RACE: {e}", flush=True)
            return 5
        print(f"host {args.host}: {outcome}", flush=True)
        return 0 if outcome in ("committed", "observed") else 3
    finally:
        if heartbeat is not None:
            heartbeat.stop()
        mgr.close()
        _write_stats(args.spill, args.host, store, writer, main_unix,
                     ready_unix)


def _write_stats(spill_dir: str, host: int, store: ObjectStore, writer,
                 main_unix: float, ready_unix: float) -> None:
    """Leave this process's launch counts and timings for the launcher."""
    import torch

    from ..kernels.adaptive_quant import ops as aq_ops
    from ..kernels.chunk_hash import ops as ch_ops

    while isinstance(store, _KillSwitchStore):
        store = store.inner
    wire = getattr(store, "stats", None)
    stats = dict(
        host=host,
        launches=dict(quant_pack=aq_ops.LAUNCHES.count,
                      chunk_hash=ch_ops.LAUNCHES.count),
        main_unix=main_unix, ready_unix=ready_unix, done_unix=time.time(),
        cuda_initialized=torch.cuda.is_initialized(),
        pipeline=(writer.stats if writer is not None else {}),
        wire=(wire.snapshot() if hasattr(wire, "snapshot") else {}))
    path = stats_path(spill_dir, host)
    with open(f"{path}.tmp", "w") as f:
        json.dump(stats, f)
    os.replace(f"{path}.tmp", path)


if __name__ == "__main__":
    sys.exit(main())
