"""The port's resharding, on the CPU: layout-independent restore across a
``num_hosts`` change (docs/resharding.md).

* a target shard under ANY ``num_hosts`` range-reads from a chain written
  under a different layout, byte-identical to the full restore's slice,
  and the target shards stitch back into the exact full state (2→3 and
  4→2), at O(target shard) bytes;
* legacy manifests (no ``layout`` record, ``hash32: null``) flow through
  the same planner; a lost source shard stays a typed ``missing-part``;
* the trainer recovers a shard straight into a NEW layout;
* ``splice_shard_state`` clears only fully covered units and gives the
  reference's state on the same inputs;
* across packages: a 2-host chain read at 3 hosts gives the reference's
  arrays and ``extra["shard"]`` for every target host.

* the elastic drill over REAL host processes: a SIGKILLed N-host save
  completes as an M-host save through ``respawn_resharded`` (2→4, 4→2).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.core import (
    CheckNRunManager,
    InMemoryStore,
    PartialRecoveryError,
)
from repro_torch.core import manifest as mf
from repro_torch.core import range_reader as rr
from repro_torch.dist import recovery
from tests.test_torch_partial_recovery import (
    META_SLACK,
    make_cfg,
    shard_slice_equal,
    table_views,
    touch,
)
from tests.test_torch_shard_writer import (
    assert_same_state,
    manager,
    save_sharded,
    sharded_snapshots,
    tiny,
)


def stitch(store_mgr, step, num_hosts):
    """Restore every target shard under ``num_hosts`` and stitch the
    slices back into full per-table arrays, asserting the shard row
    ranges exactly partition each table."""
    parts = [store_mgr.restore_part(h, step, num_hosts=num_hosts)
             for h in range(num_hosts)]
    tables, row_state = {}, {}
    for name, rec in mf.load(store_mgr.store, step).tables.items():
        spans = sorted((p.extra["shard"]["row_range"][name], i)
                       for i, p in enumerate(parts))
        cursor = 0
        tabs, accs = [], {}
        for (lo, hi), i in spans:
            assert lo == cursor, f"{name}: gap/overlap at {lo} != {cursor}"
            cursor = hi
            tabs.append(parts[i].tables[name])
            for aux, v in parts[i].row_state.get(name, {}).items():
                accs.setdefault(aux, []).append(v)
        assert cursor == rec.rows, f"{name}: shards cover {cursor}/{rec.rows}"
        tables[name] = np.concatenate(tabs, axis=0)
        row_state[name] = {a: np.concatenate(vs) for a, vs in accs.items()}
    return parts, tables, row_state


# --------------------------------------------------------------------------
# N→N±k byte-identity + O(target shard) bytes
# --------------------------------------------------------------------------


def test_reshard_grow_2_to_3_stitches_byte_identical():
    store = InMemoryStore()
    mgr = CheckNRunManager(store, make_cfg(num_hosts=2))
    snap = tiny(step=1)
    mgr.save(snap).result()

    parts, tables, row_state = stitch(mgr, 1, 3)
    for p in parts:
        assert p.extra["shard"]["resharded"] is True
        assert p.extra["shard"]["source_num_hosts"] == 2
        assert p.extra["shard"]["num_hosts"] == 3
    for name, tab in snap.tables.items():
        np.testing.assert_array_equal(tables[name], tab, err_msg=name)
        np.testing.assert_array_equal(row_state[name]["acc"],
                                      snap.row_state[name]["acc"],
                                      err_msg=name)
    met = mgr.metrics()
    assert met.recoveries_resharded_total == 3
    assert met.recoveries_partial_total == 0
    assert met.last_recovery_source_hosts == 2
    assert met.last_recovery_target_hosts == 3
    mgr.close()


def test_reshard_shrink_4_to_2_over_incremental_chain():
    store = InMemoryStore()
    mgr = CheckNRunManager(store, make_cfg(policy="one_shot"))
    snap = tiny(step=1)
    mgr.save(snap).result()
    snap2 = dataclasses.replace(touch(snap, np.random.default_rng(11)),
                                step=2)
    mgr.save(snap2).result()
    assert mf.load(store, 2).kind == "incremental"
    ref = mgr.restore(2)

    for host in range(2):
        before = store.counters.snapshot()["bytes_read"]
        rs = mgr.restore_part(host, 2, num_hosts=2)
        nbytes = store.counters.snapshot()["bytes_read"] - before
        assert rs.extra["shard"]["resharded"] is True
        shard_slice_equal(rs, ref.tables, ref.row_state)
        budget = recovery.shard_nbytes(store, host, 2, num_hosts=2)
        assert nbytes <= budget + META_SLACK
    parts, tables, _ = stitch(mgr, 2, 2)
    for name in ref.tables:
        np.testing.assert_array_equal(tables[name], ref.tables[name])
    mgr.close()


def test_reshard_bytes_o_target_shard_not_o_model():
    store = InMemoryStore()
    mgr = CheckNRunManager(store, make_cfg())
    snap = tiny(step=1, rows=2000, tables=3)
    mgr.save(snap).result()

    host, tgt = 1, 3
    before = store.counters.snapshot()["bytes_read"]
    rs = mgr.restore_part(host, num_hosts=tgt)
    part_bytes = store.counters.snapshot()["bytes_read"] - before
    shard_slice_equal(rs, snap.tables, snap.row_state)

    before = store.counters.snapshot()["bytes_read"]
    mgr.restore()
    full_bytes = store.counters.snapshot()["bytes_read"] - before

    assert part_bytes <= recovery.shard_nbytes(store, host, 1,
                                               num_hosts=tgt) + META_SLACK
    assert part_bytes < 0.5 * full_bytes  # ≈ 1/3 of tables + dense
    mgr.close()


# --------------------------------------------------------------------------
# legacy manifests through the range planner
# --------------------------------------------------------------------------


def test_reshard_legacy_manifest_no_layout_null_hash32():
    store = InMemoryStore()
    mgr = CheckNRunManager(store, make_cfg(num_hosts=1, chunk_hash=False))
    snap = tiny(step=1)
    mgr.save(snap).result()

    d = json.loads(store.get(mf.manifest_key(1)).decode())
    assert d.pop("layout") is not None
    store.put(mf.manifest_key(1), json.dumps(d).encode())
    man = mf.load(store, 1)
    assert man.layout is None
    assert man.shards is None
    assert all(ch.hash32 is None
               for rec in man.tables.values() for ch in rec.chunks)
    assert mf.layout_of(man) == {"version": 0, "kind": "row-contiguous",
                                 "num_hosts": 1}

    full = mgr.restore(1)
    for name, tab in snap.tables.items():
        np.testing.assert_array_equal(full.tables[name], tab, err_msg=name)
    parts, tables, row_state = stitch(mgr, 1, 2)
    for p in parts:
        assert p.extra["shard"]["resharded"] is True
        assert p.extra["shard"]["source_num_hosts"] == 1
    for name, tab in snap.tables.items():
        np.testing.assert_array_equal(tables[name], tab, err_msg=name)
        np.testing.assert_array_equal(row_state[name]["acc"],
                                      snap.row_state[name]["acc"],
                                      err_msg=name)
    mgr.close()


def test_manifest_records_versioned_layout():
    store = InMemoryStore()
    mgr = CheckNRunManager(store, make_cfg())
    mgr.save(tiny(step=1)).result()
    man = mf.load(store, 1)
    assert man.layout == {"version": mf.LAYOUT_VERSION,
                          "kind": "row-contiguous", "num_hosts": 4}
    assert mf.layout_of(man) is man.layout
    assert rr.layout_num_hosts(man) == 4
    mgr.close()

    s1 = InMemoryStore()
    m1 = CheckNRunManager(s1, make_cfg(num_hosts=1))
    m1.save(tiny(step=1)).result()
    assert rr.layout_num_hosts(mf.load(s1, 1)) == 1
    m1.close()


# --------------------------------------------------------------------------
# a lost source shard must NOT be papered over by resharding
# --------------------------------------------------------------------------


def test_reshard_missing_source_records_typed_missing_part():
    store = InMemoryStore()
    mgr = CheckNRunManager(store, make_cfg())
    snap = tiny(step=1)
    mgr.save(snap).result()

    lost = 2
    man = mf.load(store, 1)
    prefix = mf.chunk_host_prefix(1, lost)
    man.tables = {
        name: dataclasses.replace(rec, chunks=[
            ch for ch in rec.chunks if not ch.key.startswith(prefix)])
        for name, rec in man.tables.items()}
    store.put(mf.manifest_key(1), man.to_json().encode())
    store.delete(mf.part_key(1, lost))

    # source host 2 of 4 owns rows ~[rows/2, 3*rows/4) — inside 2-host
    # target shard 1 and disjoint from target shard 0
    rs = mgr.restore_part(0, 1, num_hosts=2)
    shard_slice_equal(rs, snap.tables, snap.row_state)
    with pytest.raises(PartialRecoveryError) as ei:
        mgr.restore_part(1, 1, num_hosts=2)
    assert ei.value.kind == "missing-part"
    mgr.close()


def test_prometheus_resharded_kind_and_layout_gauges():
    store = InMemoryStore()
    mgr = CheckNRunManager(store, make_cfg())
    mgr.save(tiny(step=1)).result()
    mgr.restore_part(0, num_hosts=2)
    text = mgr.metrics().to_prometheus()
    assert 'recoveries_total{kind="resharded"} 1' in text
    assert 'recoveries_total{kind="partial"} 0' in text
    assert "last_recovery_source_hosts 4" in text
    assert "last_recovery_target_hosts 2" in text
    mgr.close()


# --------------------------------------------------------------------------
# across packages: a 2-host chain read at 3 hosts
# --------------------------------------------------------------------------


@pytest.mark.parametrize("host", range(3))
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_reshard_2_to_3_identical_in_both_packages(writer, host):
    store = save_sharded(writer, "u8", sharded_snapshots(seed=6), num_hosts=2)
    ref, port = manager("ref", store), manager("port", store)
    for step in (1, 2):
        a = ref.restore_part(host, step, num_hosts=3)
        b = port.restore_part(host, step, num_hosts=3)
        assert b.extra["shard"]["resharded"] is True
        assert b.extra["shard"]["source_num_hosts"] == 2
        assert a.extra == b.extra
        assert_same_state(a, b)
    ref.close()
    port.close()


# --------------------------------------------------------------------------
# trainer: recover a shard straight into a NEW layout
# --------------------------------------------------------------------------


def _trainer_n(bundle, store, num_hosts):
    from repro_torch.train.loop import Trainer, TrainerConfig

    cfg = make_cfg(interval_batches=3, num_hosts=num_hosts)
    return Trainer(bundle, store, cfg, TrainerConfig(total_steps=9))


@pytest.fixture(scope="module")
def bundle():
    from repro_torch.configs import get_cell
    return get_cell("dlrm-rm2", "train_batch", reduced=True, device="cpu")


def test_trainer_recover_host_into_new_layout_inprocess(bundle):
    store = InMemoryStore()
    t2 = _trainer_n(bundle, store, 2)
    t2.init_or_restore()
    t2.run(6)                       # checkpoints at 3 and 6 under 2 hosts
    t2.close()

    t3 = _trainer_n(bundle, store, 3)
    t3.init_or_restore()            # full restore reads across layouts
    live = table_views(bundle, t3.state)
    resumed = t3.recover_host(1, mode="cpr")
    assert resumed == 6
    assert t3.last_recovery["kind"] == "resharded"
    assert t3.last_recovery["source_hosts"] == 2
    assert t3.last_recovery["target_hosts"] == 3
    # the splice wrote committed rows over live-at-committed rows — the
    # state must be unchanged (identity splice), not corrupted
    after = table_views(bundle, t3.state)
    for name in live:
        np.testing.assert_array_equal(after[name], live[name], err_msg=name)
    final = t3.run(3)               # 6→9 under the new layout
    assert final.step == 9
    assert mf.latest_step(store) == 9
    assert rr.layout_num_hosts(mf.load(store, 9)) == 3
    t3.close()


# --------------------------------------------------------------------------
# splice_shard_state
# --------------------------------------------------------------------------


def _coarse_state():
    from repro_torch.train.state import TrackedSpec, TrainState

    spec = TrackedSpec(path=("tables", "t"), units=4, rows=8, dim=2)
    state = TrainState(
        step=6,
        params={"tables": {"t": torch.zeros((8, 2))}, "dense": {}},
        opt_state={},
        touched={"t": torch.ones((4,), dtype=torch.bool)},
        rng=np.zeros((2,), np.uint32))
    return spec, state


class _Restored:
    tables = {"t": np.ones((5, 2), np.float32)}
    row_state = {"t": {}}
    extra = {"shard": {"row_range": {"t": [1, 6]}}}


def test_splice_shard_state_clears_only_fully_covered_units():
    from repro_torch.train.state import splice_shard_state

    spec, state = _coarse_state()
    out = splice_shard_state(state, _Restored(), {"t": spec})
    got = out.touched["t"].numpy()
    # rows [1,6) cover units 1,2 fully ([2,4),[4,6)); units 0,3 partially
    np.testing.assert_array_equal(got, [True, False, False, True])
    np.testing.assert_array_equal(out.params["tables"]["t"].numpy()[1:6],
                                  np.ones((5, 2)))
    np.testing.assert_array_equal(out.params["tables"]["t"].numpy()[0],
                                  np.zeros(2))
    # the state passed in is left as it was
    assert not state.params["tables"]["t"].any()
    assert state.touched["t"].all()


def _splice_inputs(seed=0):
    """A two-table state (one coarse-tracked with a 2-D accumulator, one
    row-tracked with a row-wise one) and a restore_part-like result, as
    numpy arrays both packages take."""
    rng = np.random.default_rng(seed)
    arrays = dict(
        a=rng.normal(size=(40, 4)).astype(np.float32),
        a_acc=np.abs(rng.normal(size=40)).astype(np.float32),
        b=rng.normal(size=(12, 3)).astype(np.float32),
        b_acc=np.abs(rng.normal(size=(12, 3))).astype(np.float32),
        a_touched=rng.random(40) < 0.5,
        b_touched=np.ones(4, bool),
        w=rng.normal(size=(3, 3)).astype(np.float32))
    ranges = {"a": [10, 23], "b": [5, 10]}
    restored = dict(
        tables={"a": rng.normal(size=(13, 4)).astype(np.float32),
                "b": rng.normal(size=(5, 3)).astype(np.float32)},
        row_state={"a": {"opt_acc": np.abs(rng.normal(size=13)).astype(np.float32)},
                   "b": {"opt_acc2d": np.abs(rng.normal(size=(5, 3))).astype(np.float32)}},
        extra={"shard": {"row_range": ranges}})
    return arrays, restored


def test_splice_shard_state_is_the_references():
    import jax.numpy as jnp

    from repro.train import state as ref_state
    from repro_torch.train import state as port_state

    arrays, restored = _splice_inputs()

    class R:
        tables = restored["tables"]
        row_state = restored["row_state"]
        extra = restored["extra"]

    def build(mod, to):
        specs = {"a": mod.TrackedSpec(path=("tables", "a"), units=40, rows=40, dim=4),
                 "b": mod.TrackedSpec(path=("tables", "b"), units=4, rows=12, dim=3)}
        st = mod.TrainState(
            step=to(np.asarray(7, np.int32)),
            params={"tables": {"a": to(arrays["a"]), "b": to(arrays["b"])},
                    "dense": {"w": to(arrays["w"])}},
            opt_state={"tables": {"a": to(arrays["a_acc"]), "b": to(arrays["b_acc"])}},
            touched={"a": to(arrays["a_touched"]), "b": to(arrays["b_touched"])},
            rng=to(np.zeros(2, np.uint32)))
        return mod.splice_shard_state(st, R(), specs)

    want = build(ref_state, jnp.asarray)
    got = build(port_state, lambda a: torch.from_numpy(np.array(a)))
    for name in ("a", "b"):
        np.testing.assert_array_equal(got.params["tables"][name].numpy(),
                                      np.asarray(want.params["tables"][name]))
        np.testing.assert_array_equal(got.opt_state["tables"][name].numpy(),
                                      np.asarray(want.opt_state["tables"][name]))
        np.testing.assert_array_equal(got.touched[name].numpy(),
                                      np.asarray(want.touched[name]))
    np.testing.assert_array_equal(got.params["dense"]["w"].numpy(), arrays["w"])
    # rows outside the ranges are the inputs' own, inside the restored ones
    np.testing.assert_array_equal(got.params["tables"]["a"].numpy()[:10],
                                  arrays["a"][:10])
    np.testing.assert_array_equal(got.params["tables"]["a"].numpy()[10:23],
                                  restored["tables"]["a"])


# --------------------------------------------------------------------------
# the elastic drill: complete a SIGKILLed N-host save as an M-host save
# --------------------------------------------------------------------------


ELASTIC = [
    ("before_vote", 0, 2, 4),    # grow 2→4
    ("mid_chunks:0", 1, 4, 2),   # shrink 4→2
]


@pytest.mark.parametrize("fault,victim,old_n,new_n", ELASTIC)
def test_elastic_drill_respawn_resharded(tmp_path, fault, victim, old_n,
                                         new_n):
    """SIGKILL one of ``old_n`` real host processes mid-save, then complete
    the SAME spilled step as a ``new_n``-host save: ``respawn_resharded``
    fences both layouts, purges the old-layout votes, rewrites the spill
    layout, and the relaunched fleet commits a manifest whose restore is
    the snapshot byte for byte, each new shard read at O(its target
    shard)."""
    from repro_torch.core import LocalFSStore
    from tests import test_torch_multiprocess_commit as mpc
    from tests.fault_injection import assert_no_torn_manifests

    root = str(tmp_path / "store")
    store = LocalFSStore(root)
    mgr = CheckNRunManager(store, make_cfg(num_hosts=old_n))
    snap = tiny(step=1)
    mgr.save(snap).result()
    mgr.close()

    snap2 = dataclasses.replace(touch(snap, np.random.default_rng(9)), step=2)
    codes, procs, spill = mpc.orchestrate(
        root, tmp_path, snap2, 2, faults={victim: fault}, heartbeat_s=0.1,
        num_hosts=old_n, keep_procs=True)
    assert codes[victim] == -9
    assert not store.exists(mf.manifest_key(2))   # the save aborted
    assert_no_torn_manifests(store)

    sup = recovery.RecoverySupervisor(store, old_n)
    relaunched = sup.respawn_resharded(
        root, spill, new_n, heartbeat_s=0.1,
        commit_timeout_s=mpc.COMMIT_OK_TIMEOUT_S, log_dir=str(tmp_path))
    assert sorted(relaunched) == list(range(new_n))
    assert mpc.wait_all(list(relaunched.values())) == [0] * new_n

    assert mf.latest_step(store) == 2
    assert_no_torn_manifests(store)
    man = mf.load(store, 2)
    assert rr.layout_num_hosts(man) == new_n
    assert (man.shards or {}).get("num_hosts") == new_n
    # every host of BOTH layouts was fenced against zombies
    for h in range(max(old_n, new_n)):
        assert recovery.read_fence(store, h) >= 1

    probe = CheckNRunManager(store, make_cfg(num_hosts=new_n))
    full = probe.restore(2)
    for name, tab in snap2.tables.items():
        np.testing.assert_array_equal(full.tables[name], tab, err_msg=name)
    for h in range(new_n):
        before = store.counters.snapshot()["bytes_read"]
        rs = probe.restore_part(h, 2)
        nbytes = store.counters.snapshot()["bytes_read"] - before
        shard_slice_equal(rs, snap2.tables, snap2.row_state)
        assert nbytes <= recovery.shard_nbytes(store, h, 2) + META_SLACK
    probe.close()
    # committed under one layout, it is a plain (not resharded) read there
    assert rs.extra["shard"]["resharded"] is False

    # respawning an already-committed step is refused
    with pytest.raises(RuntimeError, match="already committed"):
        sup.respawn_resharded(root, spill, new_n)
