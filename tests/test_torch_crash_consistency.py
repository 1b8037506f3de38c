"""Crash-consistency suite for the port's sharded multi-host write engine
(threads of one process, on the CPU).

The contract under test (paper §3.4 + docs/sharded_writers.md): killing ANY
one host at ANY point during a sharded save leaves the store in a state
where ``restore()`` returns the previous committed checkpoint
byte-identically, and no global manifest ever exists with missing parts.
A completed sharded save must restore byte-identically to the single-host
path on the same snapshot.
"""

import dataclasses

import numpy as np
import pytest

from repro_torch.core import (
    CheckNRunManager,
    CheckpointConfig,
    CommitCoordinator,
    InMemoryStore,
    PAPER_DEFAULTS,
    ShardCommitError,
)
from repro_torch.core import manifest as mf
from tests.fault_injection import (
    FailingStore,
    InjectedWriteError,
    assert_no_torn_manifests,
    host_keys,
)
from tests.test_torch_shard_writer import tiny

NUM_HOSTS = 4


def make_mgr(store, **overrides):
    cfg = dict(policy="one_shot", quant=None, async_write=False,
               chunk_rows=64, keep_latest=10, num_hosts=NUM_HOSTS,
               device="cpu")
    cfg.update(overrides)
    return CheckNRunManager(store, CheckpointConfig(**cfg))


def touch(snap, rng, k=40):
    """Mutate ~k rows per table in-place and set the touched masks."""
    for name, tab in snap.tables.items():
        idx = rng.choice(tab.shape[0], size=k, replace=False)
        tab[idx] += rng.normal(size=(k, tab.shape[1])).astype(np.float32)
        mask = np.zeros(tab.shape[0], bool)
        mask[idx] = True
        snap.touched[name] = mask
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
    for n in dense:
        np.testing.assert_array_equal(rs.dense[n], dense[n])


# --------------------------------------------------------------------------
# acceptance: completed sharded save ≡ single-host save, byte-identical
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [0, 4])
def test_sharded_restore_byte_identical_to_single_host(bits):
    quant = PAPER_DEFAULTS[bits] if bits else None
    snap = tiny(step=1, tables=3)
    s1, s4 = InMemoryStore(), InMemoryStore()
    make_mgr(s1, num_hosts=1, quant=quant).save(snap).result()
    make_mgr(s4, quant=quant).save(snap).result()
    r1 = make_mgr(s1, num_hosts=1, quant=quant).restore()
    r4 = make_mgr(s4, quant=quant).restore()
    assert_state_equal(r4, capture(r1))
    man = mf.load(s4, 1)
    assert man.shards["num_hosts"] == NUM_HOSTS
    assert_no_torn_manifests(s4)


def test_restore_part_matches_full_restore_slice():
    snap = tiny(step=1)
    store = InMemoryStore()
    mgr = make_mgr(store)
    mgr.save(snap).result()
    full = mgr.restore()
    for host in range(NUM_HOSTS):
        part = mgr.restore_part(host)
        for name in snap.tables:
            lo, hi = part.extra["shard"]["row_range"][name]
            np.testing.assert_array_equal(part.tables[name],
                                          full.tables[name][lo:hi])
            np.testing.assert_array_equal(part.row_state[name]["acc"],
                                          full.row_state[name]["acc"][lo:hi])


# --------------------------------------------------------------------------
# crash matrix: kill any host at any injected point → previous checkpoint
# --------------------------------------------------------------------------


@pytest.mark.parametrize("victim", range(NUM_HOSTS))
@pytest.mark.parametrize("fail_after", [0, 1, 3])
def test_killed_host_leaves_previous_checkpoint(victim,
                                                fail_after):
    """Host ``victim`` dies after ``fail_after`` of its puts (chunk writes
    or, once they are exhausted, the part-manifest vote)."""
    rng = np.random.default_rng(victim * 10 + fail_after)
    inner = InMemoryStore()
    store = FailingStore(inner)
    mgr = make_mgr(store)
    snap = tiny(step=1)
    mgr.save(snap).result()
    ref = capture(mgr.restore())

    touch(snap, rng)
    snap2 = dataclasses.replace(snap, step=2)
    store.arm(host_keys(victim), fail_after)
    with pytest.raises(InjectedWriteError):
        mgr.save(snap2).result()
    store.disarm()

    # previous checkpoint is still the latest valid one, byte-identical
    # (restored through a fresh manager, as a restarted job would)
    assert mf.latest_step(store) == 1
    assert_state_equal(CheckNRunManager(store, mgr.config).restore(), ref)
    assert_no_torn_manifests(store)

    # the job recovers: rows from the aborted interval roll into the next
    # committed checkpoint, and the orphaned debris is reclaimed post-commit
    snap3 = dataclasses.replace(snap2, step=3)
    mgr.save(snap3).result()
    assert mf.latest_step(store) == 3
    rs = mgr.restore()
    for name, tab in snap3.tables.items():
        np.testing.assert_array_equal(rs.tables[name], tab)
    assert mf.aborted_steps(store) == []
    assert_no_torn_manifests(store)
    mgr.close()


def test_vote_killed_exactly_at_part_manifest():
    """All the victim's chunks land; only its part-manifest vote fails —
    the torn-est possible state short of a committed manifest."""
    victim = 2
    inner = InMemoryStore()
    store = FailingStore(inner)
    mgr = make_mgr(store)
    snap = tiny(step=1)
    mgr.save(snap).result()
    ref = capture(mgr.restore())

    snap2 = dataclasses.replace(
        touch(snap, np.random.default_rng(7)), step=2)
    store.arm(lambda k: k == mf.part_key(2, victim), 0)
    with pytest.raises(InjectedWriteError):
        mgr.save(snap2).result()
    store.disarm()

    # victim's chunks are durable but its vote is not → no commit
    assert store.list(mf.chunk_host_prefix(2, victim)) != []
    assert not store.exists(mf.part_key(2, victim))
    assert mf.latest_step(store) == 1
    assert_state_equal(mgr.restore(), ref)
    assert_no_torn_manifests(store)
    mgr.close()


def test_stale_vote_from_prior_attempt_cannot_commit():
    """Retry of the SAME step after an aborted attempt: the victim host's
    leftover phase-1 vote (matching step/host/num_hosts stamps and chunk
    sizes) must not be laundered into a commit when the victim dies again
    before re-voting."""
    rng = np.random.default_rng(11)
    inner = InMemoryStore()
    store = FailingStore(inner)
    mgr = make_mgr(store)
    snap = tiny(step=1)
    mgr.save(snap).result()
    ref = capture(mgr.restore())

    # attempt 1 at step 2: host 3 dies exactly at its vote → hosts 0-2
    # leave durable stale votes for step 2. The fail-fast cancel races
    # the surviving hosts' votes, so repeat the aborted attempt (a
    # same-step retry purges leftovers first) until host 1's stale vote
    # is durable — the precondition the laundering check below needs.
    snap2 = dataclasses.replace(touch(snap, rng), step=2)
    for _ in range(20):
        store.arm(lambda k: k == mf.part_key(2, 3), 0)
        with pytest.raises(InjectedWriteError):
            mgr.save(snap2).result()
        store.disarm()
        if store.exists(mf.part_key(2, 1)):
            break
    voted = mf.list_part_hosts(store, 2)
    assert 1 in voted and 3 not in voted

    # attempt 2 at the same step with DIFFERENT data: host 1 dies before
    # writing anything, so only its stale attempt-1 vote could vouch for it
    snap2b = dataclasses.replace(touch(snap2, rng), step=2)
    store.arm(host_keys(1), 0)
    with pytest.raises(InjectedWriteError):
        mgr.save(snap2b).result()
    store.disarm()

    # no commit, no attempt-mixing: step 1 still restores byte-identically
    assert mf.latest_step(store) == 1
    assert not store.exists(mf.part_key(2, 1))  # stale vote was purged
    assert_state_equal(CheckNRunManager(store, mgr.config).restore(), ref)
    assert_no_torn_manifests(store)
    mgr.close()


def test_sharded_resave_of_committed_step_refused():
    """Overwriting a committed step in place would let a crash tear a
    checkpoint that claims to be valid — the sharded path refuses, and the
    committed state (manifest, votes, chunks) stays untouched."""
    store = InMemoryStore()
    mgr = make_mgr(store)
    snap = tiny(step=1)
    mgr.save(snap).result()
    before = {k: store.get(k) for k in store.list("")}
    with pytest.raises(ValueError, match="already has a committed"):
        mgr.save(dataclasses.replace(
            touch(snap, np.random.default_rng(5)), step=1)).result()
    assert {k: store.get(k) for k in store.list("")} == before
    mgr.close()


def test_coordinator_refuses_missing_part():
    """Phase 2 in isolation: with only 3 of 4 votes durable, commit raises
    and writes nothing."""
    inner = InMemoryStore()
    store = FailingStore(inner)
    mgr = make_mgr(store)
    snap = tiny(step=1)
    store.arm(lambda k: k == mf.part_key(1, 3), 0)
    with pytest.raises(InjectedWriteError):
        mgr.save(snap).result()
    store.disarm()
    # host 3's vote must be absent; hosts 0-2 voted UNLESS the fail-fast
    # cancel pre-empted them first (the cancel event races their votes —
    # any subset of {0,1,2} is a legal surviving state)
    voted = mf.list_part_hosts(store, 1)
    assert 3 not in voted
    assert set(voted) <= {0, 1, 2}

    coord = CommitCoordinator(store, NUM_HOSTS)
    with pytest.raises(ShardCommitError, match="missing"):
        coord.commit(1, kind="full", base_step=1, prev_step=None, quant=None,
                     policy={"name": "one_shot"}, extra={})
    assert mf.list_steps(store) == []
    mgr.close()


def test_coordinator_refuses_missing_chunk():
    """A vote whose chunks were tampered away must not commit (verify_chunks
    guard)."""
    store = InMemoryStore()
    mgr = make_mgr(store)
    mgr.save(tiny(step=1)).result()
    # sabotage: delete one durable chunk of host 1, keep its vote — and
    # drop the committed manifest so phase 2 actually re-runs (try_commit
    # is idempotent: an existing manifest short-circuits it)
    victim_chunks = list(store.list(mf.chunk_host_prefix(1, 1)))
    store.delete(victim_chunks[0])
    store.delete(mf.manifest_key(1))
    coord = CommitCoordinator(store, NUM_HOSTS)
    with pytest.raises(ShardCommitError, match="not durable"):
        coord.commit(1, kind="full", base_step=1, prev_step=None, quant=None,
                     policy={"name": "one_shot"}, extra={})
    mgr.close()


def test_incremental_chain_survives_crashes():
    """full → crash → increment → crash → increment: every committed step
    restores the live table exactly; crashes never corrupt the chain."""
    rng = np.random.default_rng(3)
    inner = InMemoryStore()
    store = FailingStore(inner)
    mgr = make_mgr(store, policy="consecutive")
    snap = tiny(step=1)
    mgr.save(snap).result()

    step = 1
    for round_ in range(3):
        # crashed attempt (victim rotates)
        step += 1
        snap = dataclasses.replace(touch(snap, rng), step=step)
        store.arm(host_keys(round_ % NUM_HOSTS), round_)
        with pytest.raises(InjectedWriteError):
            mgr.save(snap).result()
        store.disarm()
        # committed attempt rolls the crashed interval's rows forward
        step += 1
        snap = dataclasses.replace(touch(snap, rng), step=step)
        mgr.save(snap).result()
        rs = mgr.restore()
        for name, tab in snap.tables.items():
            np.testing.assert_array_equal(rs.tables[name], tab)
        assert_no_torn_manifests(store)
    mgr.close()
