"""The port's partial recovery, on the CPU: survive a host loss by replaying
ONE shard (docs/partial_recovery.md).

* the typed :class:`PartialRecoveryError` taxonomy for unrecoverable
  shards, with the supervisor's fallback to a full restore;
* ``restore_part`` fetches O(shard) bytes, reads across a layout change in
  the chain, and tolerates legacy manifests (null ``hash32``) and
  retention-reclaimed part manifests;
* heartbeat liveness keys and fence epochs;
* ``Trainer.recover_host`` on reduced dlrm-rm2: ``exact`` followed by
  retraining is bitwise the never-failed run (unquantized), ``cpr`` keeps
  every row outside the shard bitwise live;
* across packages: ``restore_part`` gives the reference's arrays and
  ``extra["shard"]`` for every host of a 4-host chain, whichever package
  wrote it.

* over REAL host processes (``device="cpu"``): the SIGKILL drill — kill
  any one of 4 hosts at any protocol point, detect it by exit code and
  heartbeat, ``respawn`` only the victim against the same spill to finish
  an aborted save, then replay its shard alone — and the Trainer's exact
  recovery after a host killed mid-save, bitwise the never-failed run.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.core import (
    PAPER_DEFAULTS,
    CheckNRunManager,
    CheckpointConfig,
    InMemoryStore,
    PartialRecoveryError,
)
from repro_torch.core import manifest as mf
from repro_torch.dist import recovery
from repro_torch.dist.sharding import row_shard_bounds
from tests.fault_injection import assert_no_torn_manifests
from tests.test_torch_shard_writer import (
    assert_same_state,
    manager,
    save_sharded,
    sharded_snapshots,
    tiny,
)

NUM_HOSTS = 4
# JSON/manifest overhead allowance on top of payload bytes for the
# "recovery bytes ≈ shard size" assertions (manifest + part JSONs + dense)
META_SLACK = 64 * 1024


def make_cfg(**overrides) -> CheckpointConfig:
    cfg = dict(policy="full_only", quant=None, async_write=False,
               chunk_rows=64, keep_latest=10, num_hosts=NUM_HOSTS,
               commit_timeout_s=30.0, device="cpu")
    cfg.update(overrides)
    return CheckpointConfig(**cfg)


def touch(snap, rng, k=40):
    for name, tab in snap.tables.items():
        idx = rng.choice(tab.shape[0], size=k, replace=False)
        tab[idx] += rng.normal(size=(k, tab.shape[1])).astype(np.float32)
    return snap


def capture(rs):
    return ({n: t.copy() for n, t in rs.tables.items()},
            {n: {a: v.copy() for a, v in d.items()}
             for n, d in rs.row_state.items()},
            {n: v.copy() for n, v in rs.dense.items()})


def assert_state_equal(rs, ref):
    tables, row_state, dense = ref
    assert set(rs.tables) == set(tables)
    for n in tables:
        np.testing.assert_array_equal(rs.tables[n], tables[n])
        for a in row_state[n]:
            np.testing.assert_array_equal(rs.row_state[n][a], row_state[n][a])
    assert set(rs.dense) == set(dense)
    for n in dense:
        np.testing.assert_array_equal(rs.dense[n], dense[n])


def shard_slice_equal(rs, tables, row_state=None):
    for name, tab in tables.items():
        lo, hi = rs.extra["shard"]["row_range"][name]
        np.testing.assert_array_equal(rs.tables[name], tab[lo:hi],
                                      err_msg=name)
        if row_state:
            for aux, arr in row_state[name].items():
                np.testing.assert_array_equal(rs.row_state[name][aux],
                                              arr[lo:hi], err_msg=f"{name}/{aux}")


# --------------------------------------------------------------------------
# typed errors + fallback
# --------------------------------------------------------------------------


def test_partial_recovery_error_taxonomy():
    store = InMemoryStore()
    mgr = CheckNRunManager(store, make_cfg(num_hosts=1))
    mgr.save(tiny(step=1)).result()
    with pytest.raises(PartialRecoveryError) as ei:
        mgr.restore_part(0)
    assert ei.value.kind == "not-sharded"
    assert isinstance(ei.value, ValueError)  # legacy callers still catch
    mgr.close()

    store2 = InMemoryStore()
    mgr2 = CheckNRunManager(store2, make_cfg())
    mgr2.save(tiny(step=1)).result()
    with pytest.raises(PartialRecoveryError) as ei:
        mgr2.restore_part(NUM_HOSTS + 3)
    assert ei.value.kind == "bad-host"
    with pytest.raises(FileNotFoundError):
        CheckNRunManager(InMemoryStore(), make_cfg()).restore_part(0)
    mgr2.close()


def test_broken_chain_is_typed():
    store = InMemoryStore()
    mgr = CheckNRunManager(store, make_cfg(policy="one_shot"))
    snap = tiny(step=1)
    mgr.save(snap).result()
    mgr.save(dataclasses.replace(touch(snap, np.random.default_rng(4)),
                                 step=2)).result()
    store.delete(mf.manifest_key(1))  # the increment's baseline is gone
    with pytest.raises(PartialRecoveryError) as ei:
        mgr.restore_part(0, 2)
    assert ei.value.kind == "broken-chain"
    mgr.close()


def test_restore_part_across_layout_change_in_chain():
    """An incremental whose base was written with a DIFFERENT num_hosts
    (4-host full + 2-host increment) range-reads cleanly, byte-identical
    to the full restore's slice."""
    store = InMemoryStore()
    m4 = CheckNRunManager(store, make_cfg(policy="one_shot"))
    snap = tiny(step=1)
    m4.save(snap).result()
    m4.close()
    m2 = CheckNRunManager(store, make_cfg(policy="one_shot", num_hosts=2))
    m2.restore()
    # pin the baseline so the next save is an INCREMENT riding the 4-host
    # step-1 full (the sharded manifest's policy dict doesn't rehydrate it)
    m2.policy.state.baseline_step = 1
    snap2 = dataclasses.replace(touch(snap, np.random.default_rng(1)), step=2)
    m2.save(snap2).result()
    assert mf.load(store, 2).kind == "incremental"
    ref = m2.restore(2)
    for host in range(2):
        rs = m2.restore_part(host, 2)
        assert rs.extra["shard"]["resharded"] is True
        assert rs.extra["shard"]["num_hosts"] == 2
        assert rs.extra["shard"]["source_layouts"] == [4, 2]
        shard_slice_equal(rs, ref.tables, ref.row_state)
    met = m2.metrics()
    assert met.recoveries_resharded_total == 2
    assert met.recoveries_partial_total == 0
    assert met.last_recovery_target_hosts == 2
    m2.close()


def test_corrupt_shard_chunk_typed_error_then_supervisor_full_fallback():
    store = InMemoryStore()
    mgr = CheckNRunManager(store, make_cfg(policy="one_shot"))
    snap = tiny(step=1)
    mgr.save(snap).result()
    ref = capture(mgr.restore())
    snap2 = dataclasses.replace(touch(snap, np.random.default_rng(2)), step=2)
    mgr.save(snap2).result()

    victim = 1
    key = next(k for k in sorted(store.list(mf.chunk_host_prefix(2, victim)))
               if k.endswith(".bin"))
    blob = bytearray(store.get(key))
    blob[len(blob) // 2] ^= 0x40
    store.put(key, bytes(blob))
    with pytest.raises(PartialRecoveryError) as ei:
        mgr.restore_part(victim, 2)
    assert ei.value.kind == "corrupt-chunk"

    sup = recovery.RecoverySupervisor(store, NUM_HOSTS)
    rs = sup.recover(mgr, victim, step=2)
    assert rs.extra["recovery"]["kind"] == "full"
    assert "corrupt-chunk" in rs.extra["recovery_fallback_reason"]
    # full fallback replanned past the poisoned step-2 chain onto step 1
    assert rs.degraded_from == 2 and rs.step == 1
    assert_state_equal(rs, ref)
    m = mgr.metrics()
    assert m.recoveries_full_total == 1
    assert m.last_recovery_host == victim
    assert recovery.read_fence(store, victim) == 1  # victim was fenced
    mgr.close()


def test_missing_chunk_blob_is_typed_corrupt_chunk():
    store = InMemoryStore()
    mgr = CheckNRunManager(store, make_cfg())
    mgr.save(tiny(step=1)).result()
    store.delete(sorted(store.list(mf.chunk_host_prefix(1, 2)))[0])
    with pytest.raises(PartialRecoveryError) as ei:
        mgr.restore_part(2)
    assert ei.value.kind == "corrupt-chunk"
    mgr.restore_part(1)  # other shards are intact
    mgr.close()


def test_supervisor_partial_recover_records_its_provenance():
    store = InMemoryStore()
    mgr = CheckNRunManager(store, make_cfg())
    snap = tiny(step=1)
    mgr.save(snap).result()
    sup = recovery.RecoverySupervisor(store, NUM_HOSTS)
    rs = sup.recover(mgr, 3, step=1)
    info = rs.extra["recovery"]
    assert info["kind"] == "partial" and info["host"] == 3
    assert info["fence_epoch"] == 1
    assert info["source_hosts"] == info["target_hosts"] == NUM_HOSTS
    assert 0 < info["bytes_read"] and info["wall_s"] >= 0
    shard_slice_equal(rs, snap.tables, snap.row_state)
    assert sup.recover(mgr, 3, step=1).extra["recovery"]["fence_epoch"] == 2
    mgr.close()


# --------------------------------------------------------------------------
# O(shard) bytes + metrics
# --------------------------------------------------------------------------


def test_restore_part_bytes_o_shard_not_o_model():
    store = InMemoryStore()
    mgr = CheckNRunManager(store, make_cfg())
    snap = tiny(step=1, rows=2000, tables=3)
    mgr.save(snap).result()

    host = 2
    before = store.counters.snapshot()["bytes_read"]
    rs = mgr.restore_part(host)
    part_bytes = store.counters.snapshot()["bytes_read"] - before
    shard_slice_equal(rs, snap.tables, snap.row_state)

    before = store.counters.snapshot()["bytes_read"]
    mgr.restore()
    full_bytes = store.counters.snapshot()["bytes_read"] - before

    expected = recovery.shard_nbytes(store, host, 1)
    assert part_bytes <= expected + META_SLACK
    assert part_bytes < 0.5 * full_bytes  # ≈ shard (1/4 + dense), not model

    m = mgr.metrics()
    assert m.recoveries_partial_total == 1
    assert m.recovery_rows_replayed_total > 0
    assert m.last_recovery_host == host
    assert m.last_recovery_wall_s is not None
    text = m.to_prometheus()
    assert 'recoveries_total{kind="partial"} 1' in text
    assert 'recoveries_total{kind="full"} 0' in text
    mgr.close()


@pytest.mark.parametrize("host", range(NUM_HOSTS))
def test_restore_part_matches_the_full_restores_slice_quantized(host):
    """4-bit adaptive over a full + incremental chain: each shard is the
    full restore's slice bit for bit (decode is one f32 multiply-add)."""
    store = save_sharded("port", "a4", sharded_snapshots(seed=3))
    mgr = manager("port", store)
    full = mgr.restore(2)
    rs = mgr.restore_part(host, 2)
    assert rs.chain_len == 2 and rs.step == 2
    shard_slice_equal(rs, full.tables, full.row_state)
    assert sorted(rs.dense) == sorted(full.dense)
    mgr.close()


# --------------------------------------------------------------------------
# legacy manifests + retention-reclaimed parts
# --------------------------------------------------------------------------


def test_restore_part_legacy_manifest_null_hash32():
    store = InMemoryStore()
    mgr = CheckNRunManager(store, make_cfg(chunk_hash=False))
    snap = tiny(step=1)
    mgr.save(snap).result()
    man = mf.load(store, 1)
    assert all(ch.hash32 is None
               for rec in man.tables.values() for ch in rec.chunks)
    rs = mgr.restore_part(1)
    shard_slice_equal(rs, snap.tables, snap.row_state)
    mgr.close()


def test_restore_part_survives_reclaimed_part_manifests():
    store = InMemoryStore()
    mgr = CheckNRunManager(store, make_cfg(policy="one_shot"))
    snap = tiny(step=1)
    mgr.save(snap).result()
    snap2 = dataclasses.replace(touch(snap, np.random.default_rng(7)), step=2)
    mgr.save(snap2).result()
    assert mf.load(store, 2).kind == "incremental"
    ref = mgr.restore(2)

    host = 3
    store.delete(mf.part_key(1, host))  # reclaimed on BOTH chain steps
    store.delete(mf.part_key(2, host))
    rs = mgr.restore_part(host, 2)
    assert rs.chain_len == 2
    for name in ref.tables:
        lo, hi = rs.extra["shard"]["row_range"][name]
        np.testing.assert_array_equal(rs.tables[name],
                                      ref.tables[name][lo:hi], err_msg=name)
    assert mgr.metrics().recoveries_partial_total == 1

    # but when the global manifest names NO chunks for the host either,
    # the shard is truly gone → typed missing-part
    man = mf.load(store, 2)
    prefix1 = mf.chunk_host_prefix(1, host)
    prefix2 = mf.chunk_host_prefix(2, host)
    man.tables = {
        name: dataclasses.replace(rec, chunks=[
            ch for ch in rec.chunks
            if not (ch.key.startswith(prefix1) or ch.key.startswith(prefix2))])
        for name, rec in man.tables.items()}
    store.put(mf.manifest_key(2), man.to_json().encode())
    with pytest.raises(PartialRecoveryError) as ei:
        mgr.restore_part(host, 2)
    assert ei.value.kind == "missing-part"
    mgr.close()


# --------------------------------------------------------------------------
# manager resync + re-fence
# --------------------------------------------------------------------------


def test_resync_from_and_refence_shard():
    store = InMemoryStore()
    mgr = CheckNRunManager(store, make_cfg(policy="one_shot"))
    snap = tiny(step=1)
    mgr.save(snap).result()
    touched = {n: np.ones(t.shape[0], bool) for n, t in snap.tables.items()}
    mgr.save(dataclasses.replace(snap, step=2, touched=touched)).result()
    committed_policy = mf.load(store, 2).policy
    # a half-interval of touches since the last commit, then a loss
    with mgr._lock:
        mgr._uncommitted = {n: np.ones(t.shape[0], bool)
                            for n, t in snap.tables.items()}
    mgr.refence_shard({"emb0": [10, 20], "emb1": [0, 5]})
    assert not mgr._uncommitted["emb0"][10:20].any()
    assert mgr._uncommitted["emb0"][:10].all() and mgr._uncommitted["emb0"][20:].all()
    assert not mgr._uncommitted["emb1"][:5].any() and mgr._uncommitted["emb1"][5:].all()
    mgr.policy.state.baseline_step = None
    mgr.resync_from(2)
    assert mgr._uncommitted == {} and mgr._cum_touched == {}
    assert mgr.policy.to_dict() | {"name": mgr.policy.name} == committed_policy
    mgr.close()


# --------------------------------------------------------------------------
# heartbeats + fencing
# --------------------------------------------------------------------------


def test_detect_failures_heartbeats_exit_codes_and_fences():
    store = InMemoryStore()
    now = [1000.0]
    sup = recovery.RecoverySupervisor(store, 4, heartbeat_timeout_s=5.0,
                                      now_fn=lambda: now[0])
    assert sup.detect_failures() == []
    recovery.write_heartbeat(store, 0, now=999.0)   # fresh
    recovery.write_heartbeat(store, 1, now=990.0)   # stale
    fails = sup.detect_failures()
    assert [(f.host, f.reason) for f in fails] == [(1, "stale-heartbeat")]

    class P:
        def __init__(self, code):
            self.code = code

        def poll(self):
            return self.code

    fails = sup.detect_failures({0: P(None), 1: P(-9), 2: P(0), 3: P(3)})
    assert sorted((f.host, f.exit_code) for f in fails) == [(1, -9), (3, 3)]
    assert all(f.reason == "exit-code" for f in fails)

    assert sup.fence(1) == 1
    assert recovery.read_fence(store, 1) == 1
    assert sup.detect_failures() == []
    recovery.write_heartbeat(store, 1, epoch=1, now=999.5)
    assert sup.detect_failures() == []
    now[0] = 1010.0
    assert [f.host for f in sup.detect_failures()] == [0, 1]
    assert sup.fence_layout(3) == [1, 2, 1]


def test_heartbeat_writer_beats_then_obeys_fence():
    store = InMemoryStore()
    fenced = []
    w = recovery.HeartbeatWriter(store, 2, interval_s=0.02,
                                 on_fenced=lambda: fenced.append(True))
    w.start()
    deadline = time.time() + 5.0
    while recovery.read_heartbeat(store, 2) is None and time.time() < deadline:
        time.sleep(0.01)
    hb = recovery.read_heartbeat(store, 2)
    assert hb is not None and hb["host"] == 2 and hb["epoch"] == 0
    recovery.fence_host(store, 2)
    while not fenced and time.time() < deadline:
        time.sleep(0.01)
    assert fenced and w.fenced
    w.stop()


def test_heartbeat_keys_are_the_references():
    from repro.core import InMemoryStore as RefStore
    from repro.dist import recovery as ref_recovery

    for h in (0, 3, 11):
        assert recovery.heartbeat_key(h) == ref_recovery.heartbeat_key(h)
        assert recovery.fence_key(h) == ref_recovery.fence_key(h)
    store = RefStore()
    assert recovery.fence_host(store, 2) == 1
    assert ref_recovery.read_fence(store, 2) == 1
    assert ref_recovery.fence_host(store, 2) == 2
    assert recovery.read_fence(store, 2) == 2


# --------------------------------------------------------------------------
# SIGKILL drill over REAL host processes
# --------------------------------------------------------------------------

# victims vary across protocol points: "kill ANY one of 4"
DRILL = [
    ("mid_chunks:0", 0, False),
    ("mid_chunks:2", 1, False),
    ("before_vote", 3, False),
    ("after_vote", 2, True),
    ("mid_merge", 2, True),
]


@pytest.mark.parametrize("fault,victim,may_commit", DRILL)
def test_sigkill_drill_detect_respawn_recover(tmp_path, fault, victim,
                                              may_commit):
    from tests import test_torch_multiprocess_commit as mpc

    root, store, snap, ref = mpc.committed_step1(tmp_path)
    snap2 = dataclasses.replace(touch(snap, np.random.default_rng(3)), step=2)
    codes, procs, spill = mpc.orchestrate(
        root, tmp_path, snap2, 2, faults={victim: fault}, heartbeat_s=0.1,
        race_hosts={victim} if fault == "mid_merge" else None,
        commit_timeout=(mpc.COMMIT_OK_TIMEOUT_S if may_commit
                        else mpc.COMMIT_TIMEOUT_S), keep_procs=True)
    assert codes[victim] == -9, f"victim exited {codes[victim]}, not SIGKILL"
    assert_no_torn_manifests(store)
    assert store.exists(mf.manifest_key(2)) == may_commit

    # real host processes published liveness keys before dying
    assert recovery.read_heartbeat(store, victim) is not None

    # detection: the victim is condemned by exit code; in the committed
    # cases the survivors (exit 0) are never flagged
    sup = recovery.RecoverySupervisor(store, NUM_HOSTS)
    fails = sup.detect_failures(dict(enumerate(procs)))
    assert victim in [f.host for f in fails]
    if may_commit:
        assert [f.host for f in fails] == [victim]

    if not may_commit:
        # the aborted save completes by respawning ONLY the victim against
        # the same spill: the survivors' votes are still durable, so the
        # replacement writes its chunks, votes, observes the quorum and
        # commits — no survivor restarts
        p = sup.respawn(root, spill, victim, heartbeat_s=0.1,
                        commit_timeout_s=mpc.COMMIT_TIMEOUT_S,
                        log_path=str(tmp_path / "respawn.log"))
        assert mpc.wait_all([p]) == [0]
        assert mf.latest_step(store) == 2
        assert_no_torn_manifests(store)

    # shard-only recovery at the committed step: O(shard) bytes
    mgr = CheckNRunManager(store, make_cfg())
    before = store.counters.snapshot()["bytes_read"]
    rs = sup.recover(mgr, victim, step=2)
    nbytes = store.counters.snapshot()["bytes_read"] - before
    assert rs.extra["recovery"]["kind"] == "partial"
    assert rs.step == 2
    assert nbytes <= recovery.shard_nbytes(store, victim, 2) + META_SLACK
    shard_slice_equal(rs, snap2.tables)
    # the recovered epoch outranks the dead incarnation's
    assert rs.extra["recovery"]["fence_epoch"] == 1
    mgr.close()


# --------------------------------------------------------------------------
# across packages: restore_part at 4 hosts
# --------------------------------------------------------------------------


@pytest.mark.parametrize("host", range(NUM_HOSTS))
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_restore_part_identical_in_both_packages(writer, host):
    store = save_sharded(writer, "a4", sharded_snapshots(seed=2))
    ref, port = manager("ref", store), manager("port", store)
    for step in (1, 2):
        a, b = ref.restore_part(host, step), port.restore_part(host, step)
        assert a.extra == b.extra
        assert a.chain_len == b.chain_len == step
        assert_same_state(a, b)
    ref.close()
    port.close()


# --------------------------------------------------------------------------
# Trainer: exact byte-identity + cpr (reduced dlrm-rm2, on the CPU)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bundle():
    from repro_torch.configs import get_cell
    return get_cell("dlrm-rm2", "train_batch", reduced=True, device="cpu")


def _trainer(bundle, store, **cfg_overrides):
    from repro_torch.train.loop import Trainer, TrainerConfig

    cfg = make_cfg(interval_batches=3, **cfg_overrides)
    return Trainer(bundle, store, cfg, TrainerConfig(total_steps=9))


def _flat(tree):
    from repro_torch.tree import flatten_with_path, keystr
    return {keystr(p): leaf.detach().cpu().numpy().copy()
            for p, leaf in flatten_with_path(tree)}


def table_views(bundle, state):
    from repro_torch.train.state import tree_get
    return {name: tree_get(state.params, spec.path).detach().cpu().numpy()
            .reshape(spec.rows, spec.dim).copy()
            for name, spec in bundle.tracked.items()}


def test_recover_host_exact_bitwise_inprocess(bundle):
    """Mid-interval host loss under ``exact``: survivors roll back from the
    retained boundary snapshot, the failed shard replays from the store,
    and retraining reproduces the never-failed run bit for bit."""
    ref = _trainer(bundle, InMemoryStore())
    ref.init_or_restore()
    ref_state = ref.run(9)
    ref.close()

    store = InMemoryStore()
    t = _trainer(bundle, store)
    t.init_or_restore()
    t.run(7)                      # checkpoints at 3 and 6; dies "at" 7
    assert sorted(t._boundary_snaps) == [3, 6]
    before = store.counters.snapshot()["bytes_read"]
    resumed = t.recover_host(1, mode="exact")
    nbytes = store.counters.snapshot()["bytes_read"] - before
    assert resumed == 6 and t.state.step == 6
    assert t.last_recovery["kind"] == "partial"
    assert t.last_recovery["mode"] == "exact"
    assert t.manager.metrics().restore_bytes_total \
        <= recovery.shard_nbytes(store, 1, 6)
    probe = CheckNRunManager(store, dataclasses.replace(t.ckpt_cfg))
    b0 = store.counters.snapshot()["bytes_read"]
    probe.restore(6)
    full_bytes = store.counters.snapshot()["bytes_read"] - b0
    probe.close()
    assert nbytes < full_bytes
    final = t.run(3)              # retrain 6→9
    assert mf.latest_step(store) == 9
    t.close()
    a, b = _flat(ref_state.params), _flat(final.params)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    oa, ob = _flat(ref_state.opt_state), _flat(final.opt_state)
    for k in oa:
        np.testing.assert_array_equal(oa[k], ob[k], err_msg=k)
    assert_no_torn_manifests(store)


def test_recover_host_exact_survivors_equal_the_boundary_snapshot(bundle):
    """What exact mode promises on any device: survivors' rows equal the
    retained boundary snapshot, the victim's rows equal restore(6)'s."""
    store = InMemoryStore()
    t = _trainer(bundle, store, quant=PAPER_DEFAULTS[4], policy="intermittent")
    t.init_or_restore()
    t.run(7)
    snap6 = t._boundary_snaps[6]
    victim = 2
    assert t.recover_host(victim, mode="exact") == 6
    full = CheckNRunManager(store, t.ckpt_cfg).restore(6)
    got = table_views(bundle, t.state)
    for name, spec in bundle.tracked.items():
        lo, hi = row_shard_bounds(spec.rows, NUM_HOSTS)[victim]
        keep = np.ones(spec.rows, bool)
        keep[lo:hi] = False
        np.testing.assert_array_equal(got[name][keep], snap6.tables[name][keep])
        np.testing.assert_array_equal(got[name][lo:hi], full.tables[name][lo:hi])
        acc = t.state.opt_state["tables"][name].numpy()
        np.testing.assert_array_equal(acc[keep],
                                      snap6.row_state[name]["opt_acc"][keep])
        assert not t.state.touched[name].any()
    t.run(2)
    t.close()


def test_recover_host_exact_without_a_boundary_falls_back_to_full(bundle):
    store = InMemoryStore()
    t = _trainer(bundle, store)
    t.init_or_restore()
    t.run(7)
    t._boundary_snaps.clear()  # as in a fresh process
    assert t.recover_host(0, mode="exact") == 6
    assert t.last_recovery["kind"] == "full"
    full = CheckNRunManager(store, t.ckpt_cfg).restore(6)
    got = table_views(bundle, t.state)
    for name in got:
        np.testing.assert_array_equal(got[name], full.tables[name], err_msg=name)
    t.close()


def test_recover_host_cpr_keeps_survivor_state_inprocess(bundle):
    """Under ``cpr`` only the failed shard's rows roll back; every other
    row and the step counter keep their LIVE values, the caller's live
    tensors are left as they were, and training resumes with no
    retraining."""
    store = InMemoryStore()
    t = _trainer(bundle, store)
    t.init_or_restore()
    t.run(7)
    victim = 2
    held = t.state
    live = table_views(bundle, held)
    held_touched = {k: v.clone() for k, v in held.touched.items()}
    resumed = t.recover_host(victim, mode="cpr")
    assert resumed == 7
    assert t.last_recovery["kind"] == "partial"
    assert t.last_recovery["mode"] == "cpr"
    after = table_views(bundle, t.state)
    full = CheckNRunManager(store, t.ckpt_cfg).restore(6)
    changed = 0
    for name, spec in bundle.tracked.items():
        lo, hi = row_shard_bounds(spec.rows, NUM_HOSTS)[victim]
        np.testing.assert_array_equal(after[name][:lo], live[name][:lo],
                                      err_msg=f"{name} below shard")
        np.testing.assert_array_equal(after[name][hi:], live[name][hi:],
                                      err_msg=f"{name} above shard")
        np.testing.assert_array_equal(after[name][lo:hi],
                                      full.tables[name][lo:hi])
        if not np.array_equal(after[name][lo:hi], live[name][lo:hi]):
            changed += 1
        # the Trainer's previous state object still holds live values
        np.testing.assert_array_equal(table_views(bundle, held)[name], live[name])
        assert torch.equal(held.touched[name], held_touched[name])
        assert not t.state.touched[name][lo:hi].any()
    assert changed > 0, "no shard rows were spliced back to committed state"
    final = t.run(2)              # 7→9 without retraining 6→7
    assert final.step == 9
    assert mf.latest_step(store) == 9
    t.close()


def test_recover_host_refuses_unknown_mode_and_empty_store(bundle):
    t = _trainer(bundle, InMemoryStore())
    t.init_or_restore()
    with pytest.raises(ValueError, match="staleness mode"):
        t.recover_host(0, mode="stale")
    with pytest.raises(FileNotFoundError):
        t.recover_host(0)
    t.close()


def test_trainer_exact_recovery_multiprocess_byte_identical(bundle, tmp_path):
    """The full drill over real host processes: a host SIGKILLed mid-save
    aborts the step-9 checkpoint; exact-mode recovery replays only that
    shard, survivors roll back in memory, and retraining is bitwise the
    never-failed run at O(shard) recovery bytes."""
    from repro_torch.core import LocalFSStore
    from repro_torch.dist import host_proc
    from tests import test_torch_multiprocess_commit as mpc

    ref = _trainer(bundle, InMemoryStore())
    ref.init_or_restore()
    ref_state = ref.run(9)
    ref.close()

    root = str(tmp_path / "store")
    store = LocalFSStore(root)
    t = _trainer(bundle, store, multiprocess=True, spill_dir=str(tmp_path),
                 heartbeat_s=0.1, commit_timeout_s=mpc.COMMIT_TIMEOUT_S,
                 failfast_grace_s=1.0, write_deadline_s=mpc.HOST_WAIT_S)
    t.init_or_restore()
    t.run(6)
    assert mf.latest_step(store) == 6
    t.manager.config.proc_fault = "1:mid_chunks:1"   # SIGKILL host 1 mid-save
    with pytest.raises(host_proc.MultiprocessSaveError):
        t.run(3)                                     # the step-9 save dies
    t.manager.config.proc_fault = None
    assert mf.latest_step(store) == 6                # survivors' store intact

    resumed = t.recover_host(1, mode="exact")
    assert resumed == 6
    assert t.last_recovery["kind"] == "partial"
    assert t.manager.metrics().restore_bytes_total \
        <= recovery.shard_nbytes(store, 1, 6)
    final = t.run(3)                                 # retrain; step 9 commits
    assert mf.latest_step(store) == 9
    t.close()
    a, b = _flat(ref_state.params), _flat(final.params)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert_no_torn_manifests(store)
