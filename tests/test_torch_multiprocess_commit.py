"""The port's coordinator-less commit over REAL host processes, on the CPU
(the analog of ``tests/test_multiprocess_commit.py``).

Each host runs as its own OS process (``python -m
repro_torch.dist.host_proc``, here with ``device="cpu"``) over a shared
``LocalFSStore``; after voting, each host polls the parts namespace and
the last to observe all votes commits the global manifest itself.
SIGKILLing any host process at any protocol point never loses the
previous committed step; two hosts racing phase 2 write one manifest whose
bytes do not depend on the winner. Across packages: a port multiprocess
save, a port thread-simulated save and a reference multiprocess save of
the same snapshots write the same chunk objects byte for byte (8-bit
uniform, a full and an incremental step), and each store restores
identically in either package.

Every wait on a host process is bounded (``orchestrate``'s
``HOST_WAIT_S``, the manager's ``write_deadline_s``): a hung child fails
its test and is killed, not the run.
"""

import dataclasses
import os
import subprocess
import time

import numpy as np
import pytest

from repro_torch.core import (
    CheckNRunManager,
    CheckpointConfig,
    CommitContext,
    InMemoryStore,
    LocalFSStore,
    Snapshot,
)
from repro_torch.core import manifest as mf
from repro_torch.dist import host_proc
from tests.fault_injection import assert_no_torn_manifests
from tests.test_torch_partial_recovery import (
    assert_state_equal,
    capture,
    touch,
)
from tests.test_torch_shard_writer import (
    _port_quant,
    _ref_quant,
    assert_same_state,
    sharded_snapshots,
    tiny,
)

NUM_HOSTS = 4
# quorum wait for hosts whose peer died before voting. A case that expects
# no commit ends with every survivor timing out, however slow its peers, so
# a short wait only makes it faster; a case that expects a commit waits
# COMMIT_OK_TIMEOUT_S, so a peer slow to start under load (torch takes
# about 2.5 s to import) cannot time the quorum out.
COMMIT_TIMEOUT_S = 3.0
COMMIT_OK_TIMEOUT_S = 30.0
# the bound on any one host process's life in these tests
HOST_WAIT_S = 90.0


def make_cfg(**overrides) -> CheckpointConfig:
    cfg = dict(policy="full_only", quant=None, async_write=False,
               chunk_rows=64, keep_latest=10, num_hosts=NUM_HOSTS,
               commit_timeout_s=30.0, device="cpu",
               # the parent SIGTERMs a wedged host past this (+ grace)
               write_deadline_s=HOST_WAIT_S)
    cfg.update(overrides)
    return CheckpointConfig(**cfg)


def wait_all(procs, timeout=HOST_WAIT_S):
    """Exit codes of ``procs``; kills every one still running at the
    deadline and fails."""
    deadline = time.monotonic() + timeout
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=max(0.1, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail(f"a host process outlived {timeout} s")
    return codes


def orchestrate(store_root, tmp_path, snap, step, *, faults=None,
                race_commit=False, race_hosts=None, dump_manifests=False,
                num_hosts=NUM_HOSTS, commit_timeout=COMMIT_TIMEOUT_S,
                heartbeat_s=None, keep_procs=False):
    """Spill ``snap`` and run one real host process per host, with optional
    per-host ``--fault`` SIGKILL points. ``race_commit`` (all hosts) or
    ``race_hosts`` (a subset) force the committer path. Returns (exit
    codes, dump paths), or (exit codes, procs, spill) with
    ``keep_procs``."""
    cfg = make_cfg(num_hosts=num_hosts, multiprocess=True,
                   heartbeat_s=heartbeat_s)
    ctx = CommitContext(kind="full", base_step=step, prev_step=None,
                        quant=None, policy={"name": "full_only"},
                        extra={"bitwidth": None})
    spill = str(tmp_path / f"spill_{step}")
    host_proc.write_spill(spill, snap, {}, {}, cfg, step, num_hosts, ctx,
                          verify_chunks=True)
    env = host_proc.child_env()
    procs, dumps = [], []
    for h in range(num_hosts):
        dump = str(tmp_path / f"would_commit_{h}.json")
        dumps.append(dump)
        cmd = host_proc.host_command(
            store_root, spill, h,
            fault=(faults or {}).get(h),
            race_commit=race_commit or h in (race_hosts or ()),
            dump_manifest=dump if dump_manifests else None,
            heartbeat_s=heartbeat_s,
            poll_interval_s=0.02, commit_timeout_s=commit_timeout)
        with open(str(tmp_path / f"host_{h}.log"), "wb") as log:
            procs.append(subprocess.Popen(cmd, env=env, stdout=log,
                                          stderr=subprocess.STDOUT))
    codes = wait_all(procs)
    if keep_procs:
        return codes, procs, spill
    return codes, dumps


def committed_step1(tmp_path, **kw):
    """A committed 4-host step-1 checkpoint on a LocalFSStore, its restored
    state, and the snapshot used — shared setup for the crash matrix."""
    root = str(tmp_path / "store")
    store = LocalFSStore(root)
    mgr = CheckNRunManager(store, make_cfg())
    snap = tiny(step=1, **kw)
    mgr.save(snap).result()
    ref = capture(mgr.restore())
    mgr.close()
    return root, store, snap, ref


# --------------------------------------------------------------------------
# byte identity: multiprocess = thread-simulated = single host
# --------------------------------------------------------------------------


def test_multiprocess_restores_byte_identical_to_thread_and_single(tmp_path):
    snap = tiny(step=1, tables=3)

    s1 = InMemoryStore()
    m1 = CheckNRunManager(s1, make_cfg(num_hosts=1))
    m1.save(snap).result()
    ref = capture(m1.restore())
    m1.close()

    st = InMemoryStore()
    mt = CheckNRunManager(st, make_cfg())
    mt.save(snap).result()

    root = str(tmp_path / "store")
    sp = LocalFSStore(root)
    mp = CheckNRunManager(sp, make_cfg(multiprocess=True,
                                       spill_dir=str(tmp_path)))
    res = mp.save(snap).result()
    assert res.pipeline_stats["multiprocess"] is True
    assert res.pipeline_stats["exit_codes"] == [0] * NUM_HOSTS

    assert_state_equal(mt.restore(), ref)
    assert_state_equal(mp.restore(), ref)

    # the blob layer is byte-identical between thread-simulated and
    # real-process hosts: same chunk keys, same payload bytes
    t_chunks = {k: st.get(k) for k in st.list("chunks/")}
    p_chunks = {k: sp.get(k) for k in sp.list("chunks/")}
    assert t_chunks == p_chunks
    man = mf.load(sp, 1)
    assert man.shards["num_hosts"] == NUM_HOSTS
    assert_no_torn_manifests(sp)
    # the spill is gone, on every path
    assert not [e for e in os.listdir(tmp_path) if e.startswith("cnr-spill-")]
    mt.close()
    mp.close()


def test_host_processes_report_their_stats(tmp_path):
    """Each process leaves its launch counts and timings for the launcher
    (its counters live in its own address space); on the CPU the kernels'
    plain versions run, which count no launch, and CUDA is never
    initialised."""
    root = str(tmp_path / "store")
    mgr = CheckNRunManager(LocalFSStore(root), make_cfg(
        multiprocess=True, spill_dir=str(tmp_path), quant=_port_quant("u8")))
    res = mgr.save(tiny(step=1)).result()
    mgr.close()
    ps = res.pipeline_stats
    assert ps["spill_bytes"] > 0 and ps["spill_s"] >= 0
    assert [st["host"] for st in ps["per_host"]] == list(range(NUM_HOSTS))
    for st in ps["per_host"]:
        assert st["launches"] == {"quant_pack": 0, "chunk_hash": 0}
        assert st["cuda_initialized"] is False
        assert 0 < st["import_s"] <= st["startup_s"] <= st["proc_wall_s"] < HOST_WAIT_S
        assert st["main_unix"] <= st["ready_unix"] <= st["done_unix"]
        assert st["pipeline"]["items"] > 0
        assert st["wire"] == {}          # a LocalFSStore has no wire
    # the hosts' payloads are the committed step's chunk and dense blobs
    store = LocalFSStore(root)
    man = mf.load(store, 1)
    assert sum(st["pipeline"]["payload_bytes"] for st in ps["per_host"]) == (
        sum(ch.nbytes for rec in man.tables.values() for ch in rec.chunks)
        + sum(store.size(d.key) for d in man.dense.values()))


def _save_multiprocess(package, root, snaps, spill_dir):
    kw = dict(policy="one_shot", async_write=False, chunk_rows=64,
              num_hosts=NUM_HOSTS, keep_latest=10, multiprocess=True,
              spill_dir=spill_dir, write_deadline_s=HOST_WAIT_S)
    if package == "ref":
        from repro.core import CheckNRunManager as RefManager
        from repro.core import CheckpointConfig as RefConfig
        from repro.core import LocalFSStore as RefLocalFSStore
        from repro.core import Snapshot as RefSnapshot
        store = RefLocalFSStore(root)
        mgr = RefManager(store, RefConfig(quant=_ref_quant("u8"), **kw))
        mk = RefSnapshot
    else:
        store = LocalFSStore(root)
        mgr = CheckNRunManager(store, CheckpointConfig(
            quant=_port_quant("u8"), device="cpu", **kw))
        mk = Snapshot
    for s in snaps:
        res = mgr.save(mk(**s)).result()
        assert res.pipeline_stats["exit_codes"] == [0] * NUM_HOSTS
    mgr.close()
    return store


def test_multiprocess_chunks_identical_across_packages_and_threads(tmp_path):
    """Trouble spot of the port: the same two snapshots (full, then
    incremental) saved three ways — port host processes, port threads, and
    reference host processes — write the same chunk objects key for key,
    and every store restores identically in either package."""
    from tests.test_torch_shard_writer import manager, save_sharded

    snaps = sharded_snapshots(seed=3)
    port_mp = _save_multiprocess("port", str(tmp_path / "port"), snaps,
                                 str(tmp_path))
    ref_mp = _save_multiprocess("ref", str(tmp_path / "ref"), snaps,
                                str(tmp_path))
    port_thr = save_sharded("port", "u8", snaps)
    chunks = [{k: s.get(k) for k in s.list("chunks/")}
              for s in (port_mp, ref_mp, port_thr)]
    assert len(chunks[0]) > 2 * NUM_HOSTS
    assert chunks[0] == chunks[1] == chunks[2]
    assert mf.load(port_mp, 2).kind == "incremental"
    for step in (1, 2):
        for store in (port_mp, ref_mp):
            a, b = manager("port", store), manager("ref", store)
            assert_same_state(a.restore(step), b.restore(step))
            a.close()
            b.close()


def test_multiprocess_requires_localfs_store():
    mgr = CheckNRunManager(InMemoryStore(),
                           make_cfg(num_hosts=2, multiprocess=True))
    with pytest.raises(ValueError, match="LocalFSStore"):
        mgr.save(tiny(step=1)).result()
    mgr.close()


# --------------------------------------------------------------------------
# crash matrix: SIGKILL any host process at any protocol point
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fault,may_commit", [
    ("mid_chunks:0", False),   # first chunk put never lands
    ("mid_chunks:2", False),   # dies partway through its shard
    ("before_vote", False),    # chunks durable, killed at the vote put
    ("after_vote", True),      # vote durable → peers form the quorum
    ("mid_merge", True),       # killed at the manifest put → a peer commits
])
def test_sigkilled_host_never_loses_previous_step(tmp_path, fault, may_commit):
    root, store, snap, ref = committed_step1(tmp_path)
    victim = 2
    snap2 = dataclasses.replace(touch(snap, np.random.default_rng(3)), step=2)
    # mid_merge: pin the victim to the committer path (--race-commit), or a
    # faster peer may commit first and the victim exits via the observed
    # fast path without ever reaching its own manifest put
    codes, _ = orchestrate(root, tmp_path, snap2, 2,
                           faults={victim: fault},
                           race_hosts={victim} if fault == "mid_merge"
                           else None,
                           commit_timeout=(COMMIT_OK_TIMEOUT_S if may_commit
                                           else COMMIT_TIMEOUT_S))

    assert codes[victim] == -9, f"victim exited {codes[victim]}, not SIGKILL"
    assert_no_torn_manifests(store)
    committed = store.exists(mf.manifest_key(2))
    if not may_commit:
        # quorum never formed: peers time out (exit 3), nothing commits
        assert not committed
        assert mf.latest_step(store) == 1
        assert all(c == 3 for h, c in enumerate(codes) if h != victim), codes
    else:
        assert committed
        assert mf.latest_step(store) == 2
        rs = CheckNRunManager(store, make_cfg()).restore()
        for name, tab in snap2.tables.items():
            np.testing.assert_array_equal(rs.tables[name], tab)
    # in EVERY case the previous committed step restores byte-identically
    rs = CheckNRunManager(store, make_cfg()).restore(step=1)
    assert_state_equal(rs, ref)


def test_all_committers_sigkilled_mid_merge_previous_step_survives(tmp_path):
    """Every host dies exactly at the manifest put — all votes and chunks
    durable, the commit point never lands. The previous step restores
    byte-identically, and the port's ``ckpt commit`` finishes phase 2 from
    the durable votes."""
    root, store, snap, ref = committed_step1(tmp_path)
    snap2 = dataclasses.replace(touch(snap, np.random.default_rng(5)), step=2)
    codes, _ = orchestrate(root, tmp_path, snap2, 2,
                           faults={h: "mid_merge" for h in range(NUM_HOSTS)})
    assert codes == [-9] * NUM_HOSTS
    assert not store.exists(mf.manifest_key(2))
    assert mf.list_part_hosts(store, 2) == list(range(NUM_HOSTS))
    assert mf.latest_step(store) == 1
    assert_state_equal(CheckNRunManager(store, make_cfg()).restore(), ref)
    assert_no_torn_manifests(store)

    from repro_torch.launch.ckpt import main as ckpt_main
    assert ckpt_main(["commit", "--dir", root, "--step", "2",
                      "--num-hosts", str(NUM_HOSTS)]) == 0
    assert mf.latest_step(store) == 2
    rs = CheckNRunManager(store, make_cfg()).restore()
    for name, tab in snap2.tables.items():
        np.testing.assert_array_equal(rs.tables[name], tab)
    assert_no_torn_manifests(store)


def test_manager_save_with_a_killed_host_raises_and_keeps_the_last_step(
        tmp_path):
    """``proc_fault`` through the manager: the save raises
    ``MultiprocessSaveError`` carrying the exit codes and log tails, the
    survivors are terminated after the fail-fast grace, and the previous
    step stays latest and restores."""
    root, store, snap, ref = committed_step1(tmp_path)
    mgr = CheckNRunManager(store, make_cfg(
        multiprocess=True, spill_dir=str(tmp_path), proc_fault="1:mid_chunks:1",
        commit_timeout_s=COMMIT_TIMEOUT_S, failfast_grace_s=1.0))
    # steps the committed_step1 manager saved are this manager's too
    snap2 = dataclasses.replace(touch(snap, np.random.default_rng(7)), step=2)
    mgr.save(snap2)
    with pytest.raises(host_proc.MultiprocessSaveError, match="-9"):
        mgr.wait()
    assert mf.latest_step(store) == 1
    assert_state_equal(mgr.restore(), ref)
    mgr.close()


# --------------------------------------------------------------------------
# phase-2 race: two hosts both commit; exactly one manifest, identical bytes
# --------------------------------------------------------------------------


def test_racing_phase2_commits_are_byte_identical(tmp_path):
    root = str(tmp_path / "store")
    store = LocalFSStore(root)
    snap = tiny(step=1)
    codes, dumps = orchestrate(root, tmp_path, snap, 1, num_hosts=2,
                               race_commit=True, dump_manifests=True,
                               commit_timeout=COMMIT_OK_TIMEOUT_S)
    assert codes == [0, 0]
    blobs = [open(d, "rb").read() for d in dumps]
    assert blobs[0] == blobs[1] and len(blobs[0]) > 0
    assert store.get(mf.manifest_key(1)) == blobs[0]
    assert_no_torn_manifests(store)
    rs = CheckNRunManager(store, make_cfg(num_hosts=2)).restore()
    for name, tab in snap.tables.items():
        np.testing.assert_array_equal(rs.tables[name], tab)


def test_ckpt_commit_refuses_incremental_votes(tmp_path):
    from repro_torch.launch.ckpt import main as ckpt_main

    root = str(tmp_path / "store")
    store = LocalFSStore(root)
    mgr = CheckNRunManager(store, make_cfg(policy="one_shot"))
    snap = tiny(step=1)
    mgr.save(snap).result()                      # full baseline
    snap2 = dataclasses.replace(touch(snap, np.random.default_rng(1)), step=2)
    mgr.save(snap2).result()                     # incremental
    assert mf.load(store, 2).kind == "incremental"
    store.delete(mf.manifest_key(2))
    assert ckpt_main(["commit", "--dir", root, "--step", "2",
                      "--num-hosts", str(NUM_HOSTS)]) == 1
    assert not store.exists(mf.manifest_key(2))
    mgr.close()


def test_try_commit_is_idempotent_in_process():
    from repro_torch.core import try_commit

    store = InMemoryStore()
    mgr = CheckNRunManager(store, make_cfg())
    mgr.save(tiny(step=1)).result()
    raw = store.get(mf.manifest_key(1))
    ctx = CommitContext(kind="full", base_step=1, prev_step=None, quant=None,
                        policy=mf.load(store, 1).policy,
                        extra=mf.load(store, 1).extra)
    man = try_commit(store, 1, NUM_HOSTS, ctx)
    assert man.step == 1
    assert store.get(mf.manifest_key(1)) == raw
    mgr.close()


def test_commit_once_rejects_divergent_manifest():
    from repro_torch.core.manifest import CommitRaceError, commit_once

    store = InMemoryStore()
    mgr = CheckNRunManager(store, make_cfg())
    mgr.save(tiny(step=1)).result()
    man = mf.load(store, 1)
    assert commit_once(store, man) is False  # identical: absorbed
    man.extra = dict(man.extra, poisoned=True)
    with pytest.raises(CommitRaceError):
        commit_once(store, man)
    mgr.close()


def test_spill_round_trips_and_rewrites_its_layout(tmp_path):
    """The spill is what a host process reads: arrays come back memory-
    mapped and equal, the config (device included) and commit context as
    written; ``rewrite_spill_layout`` changes only the host count."""
    snap = tiny(step=4)
    cfg = make_cfg(multiprocess=True, quant=_port_quant("u8"))
    ctx = CommitContext(kind="full", base_step=4, prev_step=2,
                        quant=dataclasses.asdict(cfg.quant),
                        policy={"name": "full_only"}, extra={"bitwidth": None})
    spill = str(tmp_path / "spill")
    cum = {n: np.ones(t.shape[0], bool) for n, t in snap.tables.items()}
    host_proc.write_spill(spill, snap, cum, {}, cfg, 4, NUM_HOSTS, ctx, True)
    back, cum2, unc2 = host_proc.load_spill(spill)
    assert back.step == 4 and unc2 == {}
    for n, t in snap.tables.items():
        assert isinstance(back.tables[n], np.memmap)
        np.testing.assert_array_equal(back.tables[n], t)
        np.testing.assert_array_equal(back.row_state[n]["acc"],
                                      snap.row_state[n]["acc"])
        np.testing.assert_array_equal(cum2[n], cum[n])
    for n, v in snap.dense.items():
        np.testing.assert_array_equal(back.dense[n], v)
    assert host_proc.load_config(spill) == cfg
    assert host_proc.load_commit(spill) == (4, NUM_HOSTS, True, ctx)
    host_proc.rewrite_spill_layout(spill, 2)
    assert host_proc.load_config(spill) == dataclasses.replace(cfg, num_hosts=2)
    assert host_proc.load_commit(spill)[1] == 2
    cmd = host_proc.host_command(spill, spill, 1, heartbeat_s=0.5,
                                 heartbeat_epoch=3, batch_fsync=True)
    assert cmd[1:3] == ["-m", "repro_torch.dist.host_proc"]
    assert "--batch-fsync" in cmd and cmd[cmd.index("--heartbeat-epoch") + 1] == "3"
