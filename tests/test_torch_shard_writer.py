"""The port's sharded-writer building blocks, on the CPU: row-shard
assignment, touched-set sharding, dense-param ownership, per-host vs shared
throttled links, the save-path plumbing that ties them together, and the
store format across packages — a 4-host commit written by the port restores
in the reference to the same state and the reverse, and its chunk objects
are the reference's byte for byte (unquantized and 8-bit uniform; 4-bit
adaptive within the adaptive code bound).

``tiny`` makes the conftest's ``tiny_snapshot`` arrays as a port Snapshot;
the other port sharding test files import it from here.
"""

import time

import numpy as np
import pytest

from repro_torch.core import (
    PAPER_DEFAULTS,
    CheckNRunManager,
    CheckpointConfig,
    InMemoryStore,
    LocalFSStore,
    Snapshot,
    ThrottledStore,
    host_link,
    shard_indices,
)
from repro_torch.core import manifest as mf
from repro_torch.dist.shard_writer import dense_owner
from repro_torch.dist.sharding import row_shard_bounds


def snapshot_arrays(step=1, rows=300, dim=8, tables=2, seed=0, touched=None,
                    with_dense=True, with_aux=True):
    """The conftest's ``tiny_snapshot`` fields, as numpy arrays either
    package's Snapshot takes (the same draws in the same order)."""
    rng = np.random.default_rng(seed)
    tabs = {f"emb{i}": rng.normal(size=(rows + 37 * i, dim))
            .astype(np.float32) for i in range(tables)}
    row_state = {n: ({"acc": np.abs(rng.normal(size=t.shape[0]))
                      .astype(np.float32)} if with_aux else {})
                 for n, t in tabs.items()}
    if touched is None:
        touched = {n: np.ones(t.shape[0], bool) for n, t in tabs.items()}
    dense = ({"mlp/w": rng.normal(size=(16, 16)).astype(np.float32),
              "mlp/b": rng.normal(size=(16,)).astype(np.float32)}
             if with_dense else {})
    return dict(step=step, tables=tabs, row_state=row_state, touched=touched,
                dense=dense, extra={})


def tiny(**kw) -> Snapshot:
    return Snapshot(**snapshot_arrays(**kw))


def port_cfg(**overrides) -> CheckpointConfig:
    cfg = dict(policy="full_only", quant=None, async_write=False,
               device="cpu")
    cfg.update(overrides)
    return CheckpointConfig(**cfg)


# ----------------------------------------------------------- shard bounds
@pytest.mark.parametrize("rows,num_hosts", [
    (100, 4), (101, 4), (7, 3), (3, 8), (0, 2), (1, 1), (65536, 7)])
def test_row_shard_bounds_partition(rows, num_hosts):
    bounds = row_shard_bounds(rows, num_hosts)
    assert len(bounds) == num_hosts
    # exact cover, in order, balanced to within one row
    assert bounds[0][0] == 0 and bounds[-1][1] == rows
    sizes = []
    for (lo, hi), (lo2, _) in zip(bounds, bounds[1:] + [(rows, rows)]):
        assert lo <= hi == lo2
        sizes.append(hi - lo)
    assert max(sizes) - min(sizes) <= 1


def test_row_shard_bounds_rejects_bad_host_count():
    with pytest.raises(ValueError):
        row_shard_bounds(10, 0)


def test_row_shard_bounds_is_the_references():
    from repro.dist.sharding import row_shard_bounds as ref_bounds

    for rows in (0, 1, 7, 512, 1000, 65537):
        for n in (1, 2, 3, 4, 7):
            assert row_shard_bounds(rows, n) == ref_bounds(rows, n)


def test_shard_indices_union_is_nonzero():
    rng = np.random.default_rng(0)
    mask = rng.random(1000) < 0.3
    parts = [shard_indices(mask, lo, hi)
             for lo, hi in row_shard_bounds(1000, 4)]
    union = np.concatenate(parts)
    np.testing.assert_array_equal(np.sort(union), np.nonzero(mask)[0])
    for (lo, hi), p in zip(row_shard_bounds(1000, 4), parts):
        assert np.all((p >= lo) & (p < hi))


def test_dense_owner_stable_and_in_range():
    from repro.dist.shard_writer import dense_owner as ref_owner

    names = [f"layer{i}/w" for i in range(50)]
    owners = {n: dense_owner(n, 4) for n in names}
    assert all(0 <= h < 4 for h in owners.values())
    assert owners == {n: dense_owner(n, 4) for n in names}  # deterministic
    assert len(set(owners.values())) > 1  # actually spreads
    assert owners == {n: ref_owner(n, 4) for n in names}


# ------------------------------------------------------- throttled links
def test_host_link_parses_host_namespaces():
    assert host_link("chunks/ckpt_000000000002/host_0003/emb/000000.bin") == 3
    assert host_link("parts/ckpt_000000000002/host_0011.json") == 11
    assert host_link("manifests/ckpt_000000000002.json") == 0
    assert host_link("chunks/ckpt_000000000002/emb/000000.bin") == 0


def test_per_host_links_beat_shared_link():
    """N hosts on independent links transmit N× faster than the same bytes
    on one shared aggregate link of equal per-link bandwidth. Margins are
    loose: the model sleeps, so a loaded box adds scheduling noise to the
    parallel case (ideal ratio here is 4×)."""
    payload = b"x" * 40_000
    keys = [f"chunks/ckpt_000000000001/host_{h:04d}/t/0.bin"
            for h in range(4)]

    def transmit(store):
        t0 = time.monotonic()
        store.put_many([(k, payload) for k in keys], max_workers=4)
        return time.monotonic() - t0

    shared = ThrottledStore(InMemoryStore(), write_bytes_per_sec=200_000)
    per_host = ThrottledStore(InMemoryStore(), write_bytes_per_sec=200_000,
                              num_links=4, link_of=host_link)
    t_shared = transmit(shared)      # 4 × 0.2s serialized on one link
    t_per_host = transmit(per_host)  # 4 × 0.2s in parallel
    assert t_shared > 1.5 * t_per_host
    assert t_per_host < 0.6


def test_throttled_store_default_single_link_unchanged():
    store = ThrottledStore(InMemoryStore(), write_bytes_per_sec=1e12)
    store.put("a", b"123")
    assert store.get("a") == b"123"
    assert store.num_links == 1


def test_localfs_list_rejects_escaping_prefix(tmp_path):
    root = tmp_path / "job-1"
    sibling = tmp_path / "job-1-old"
    sibling.mkdir()
    (sibling / "stray.bin").write_bytes(b"x")
    store = LocalFSStore(str(root))
    store.put("chunks/a.bin", b"1")
    assert list(store.list("chunks/")) == ["chunks/a.bin"]
    with pytest.raises(ValueError, match="escapes store root"):
        store.list("../job-1-old/")


def test_host_failure_cancels_surviving_hosts():
    """One host's write error must fail the save fast: the shared cancel
    event aborts the other hosts' throttled uploads instead of letting them
    transmit their full shards (and vote) on a doomed save."""
    from tests.fault_injection import FailingStore, InjectedWriteError, host_keys

    snap = tiny(step=1, rows=4000, dim=32, tables=2)
    payload = sum(t.nbytes for t in snap.tables.values())
    throttled = ThrottledStore(InMemoryStore(),
                               write_bytes_per_sec=payload / 8)
    store = FailingStore(throttled, match=host_keys(0), fail_after=0)
    mgr = CheckNRunManager(store, port_cfg(chunk_rows=256, num_hosts=4))
    t0 = time.monotonic()
    with pytest.raises(InjectedWriteError):
        mgr.save(snap).result()
    elapsed = time.monotonic() - t0
    assert elapsed < 5.0, f"survivors were not cancelled ({elapsed:.1f}s)"
    assert mf.list_part_hosts(store, 1) == []
    mgr.close()


def test_run_host_writers_attaches_every_host_failure():
    """With several hosts failing independently, every other real failure
    rides the root exception as a note (derived cancellations excluded)."""
    from repro_torch.dist.shard_writer import HostShardWriter, run_host_writers

    class Scripted(HostShardWriter):
        def __init__(self, host, exc):
            super().__init__(host, 4, InMemoryStore(), encoder=None)
            self._exc = exc

        def write_part(self, snap, decision, qcfg, cum, unc):
            if self._exc is not None:
                raise self._exc
            return None

    class FakeSnap:
        step = 9

    writers = [Scripted(0, None),
               Scripted(1, ValueError("host1 disk full")),
               Scripted(2, None),
               Scripted(3, OSError("host3 link down"))]
    with pytest.raises(ValueError, match="host1 disk full") as ei:
        run_host_writers(writers, FakeSnap(), "full", None, {}, {})
    notes = getattr(ei.value, "__notes__", [])
    assert any("raised by host 1" in n for n in notes), notes
    assert any("host 3 also failed: OSError: host3 link down" in n
               for n in notes), notes


# ------------------------------------------------------------- plumbing
def test_sharded_save_key_layout():
    store = InMemoryStore()
    mgr = CheckNRunManager(store, port_cfg(chunk_rows=64, num_hosts=3))
    mgr.save(tiny(step=7)).result()
    man = mf.load(store, 7)
    hosts_seen = set()
    for rec in man.tables.values():
        total = 0
        for ch in rec.chunks:
            assert ch.key.startswith(mf.chunk_prefix(7))
            assert "/host_" in ch.key
            hosts_seen.add(host_link(ch.key))
            total += ch.n_rows
        assert total == rec.rows  # full save covers every row exactly once
    assert hosts_seen == {0, 1, 2}
    assert mf.list_part_hosts(store, 7) == [0, 1, 2]
    for name, drec in man.dense.items():
        assert host_link(drec.key) == dense_owner(name, 3)
    mgr.close()


def test_more_hosts_than_rows():
    """Hosts with empty shards still vote; the checkpoint commits and
    restores exactly."""
    snap = tiny(step=1, rows=3, tables=1)
    store = InMemoryStore()
    mgr = CheckNRunManager(store, port_cfg(num_hosts=8))
    mgr.save(snap).result()
    assert mf.list_part_hosts(store, 1) == list(range(8))
    rs = mgr.restore()
    np.testing.assert_array_equal(rs.tables["emb0"], snap.tables["emb0"])
    mgr.close()


def test_sharded_honors_pipeline_off():
    snap = tiny(step=1)
    store = InMemoryStore()
    mgr = CheckNRunManager(store, port_cfg(chunk_rows=64, num_hosts=3,
                                           pipeline=False))
    res = mgr.save(snap).result()
    assert res.pipeline_stats["num_hosts"] == 3
    rs = mgr.restore()
    for name, tab in snap.tables.items():
        np.testing.assert_array_equal(rs.tables[name], tab)
    mgr.close()


def test_save_result_reports_per_host_stats():
    store = InMemoryStore()
    mgr = CheckNRunManager(store, port_cfg(num_hosts=2))
    res = mgr.save(tiny(step=1)).result()
    stats = res.pipeline_stats
    assert stats["num_hosts"] == 2
    assert len(stats["per_host"]) == 2
    assert [s["host"] for s in stats["per_host"]] == [0, 1]
    assert stats["items"] == sum(s["items"] for s in stats["per_host"])
    assert res.nbytes > 0
    mgr.close()


def test_async_sharded_save_commits():
    """The default async writer thread drives the host threads too."""
    store = InMemoryStore()
    mgr = CheckNRunManager(store, port_cfg(num_hosts=4, async_write=True,
                                           chunk_rows=64))
    snap = tiny(step=3)
    mgr.save(snap)
    res = mgr.wait()
    assert res.kind == "full" and mf.latest_step(store) == 3
    rs = mgr.restore()
    for name, tab in snap.tables.items():
        np.testing.assert_array_equal(rs.tables[name], tab)
    mgr.close()


def test_quantized_chunks_launch_one_quant_pack_and_hash_each(monkeypatch):
    """Every chunk of every host goes through the fused encode once: one
    ``quant_pack`` and one ``chunk_hash`` call a chunk (their plain versions
    here), the counts the card run checks."""
    from repro_torch.kernels.adaptive_quant import ops as aq
    from repro_torch.kernels.chunk_hash import ops as ch

    calls = {"qp": 0, "hash": 0}
    qp, hw = aq.quant_pack, ch.hash_words_async

    def count_qp(*a, **k):
        calls["qp"] += 1
        return qp(*a, **k)

    def count_hash(*a, **k):
        calls["hash"] += 1
        return hw(*a, **k)

    from repro_torch.core import checkpoint as cp
    monkeypatch.setattr(aq, "quant_pack", count_qp)
    monkeypatch.setattr(cp, "hash_words_async", count_hash)
    store = InMemoryStore()
    mgr = CheckNRunManager(store, port_cfg(num_hosts=4, chunk_rows=40,
                                           quant=PAPER_DEFAULTS[4]))
    mgr.save(tiny(step=1)).result()
    mgr.close()
    man = mf.load(store, 1)
    n = sum(len(r.chunks) for r in man.tables.values())
    # 300 rows: 4 shards of 75 rows, 2 chunks of at most 40 rows each;
    # 337 rows: shards of 84-85 rows, 3 chunks each
    assert n == 4 * 2 + 4 * 3
    assert calls == {"qp": n, "hash": n}
    assert all(c.hash32 is not None
               for r in man.tables.values() for c in r.chunks)


# ------------------------------------------------------ across packages
QUANT = {"none": (None, None), "u8": (8, 8), "a4": (4, 4)}


def _ref_quant(key):
    from repro.core import PAPER_DEFAULTS as REF_DEFAULTS
    bits = QUANT[key][0]
    return REF_DEFAULTS[bits] if bits else None


def _port_quant(key):
    bits = QUANT[key][1]
    return PAPER_DEFAULTS[bits] if bits else None


def sharded_snapshots(seed=0):
    """A full-save snapshot and an incremental one (steps 1 and 2) with
    DLRM-like keys, as numpy arrays shared by both packages."""
    rng = np.random.default_rng(seed)
    tables = {"emb_0": (rng.normal(size=(900, 16))
                        * rng.gamma(1.0, 1.0, (900, 1))).astype(np.float32),
              "emb_1": rng.normal(size=(257, 8)).astype(np.float32)}
    aux = {n: {"opt_acc": np.abs(rng.normal(size=t.shape[0])).astype(np.float32)}
           for n, t in tables.items()}
    dense = {"params['bot'][0]['w']": rng.normal(size=(13, 16)).astype(np.float32),
             "params['bot'][0]['b']": np.zeros(16, np.float32),
             "step": np.asarray(1, np.int32),
             "rng": np.array([0, 1], np.uint32)}
    full = dict(step=1, tables=tables, row_state=aux,
                touched={n: np.ones(t.shape[0], bool) for n, t in tables.items()},
                dense=dense, extra={"reader": {"next_batch": 1}})
    tables2 = {n: t.copy() for n, t in tables.items()}
    touched2 = {}
    for n, t in tables2.items():
        m = np.zeros(t.shape[0], bool)
        m[rng.choice(t.shape[0], t.shape[0] // 7, replace=False)] = True
        t[m] += 0.25
        touched2[n] = m
    inc = dict(step=2, tables=tables2, row_state=aux, touched=touched2,
               dense={**dense, "step": np.asarray(2, np.int32)},
               extra={"reader": {"next_batch": 2}})
    return full, inc


def save_sharded(package, quant_key, snaps, num_hosts=4, store=None,
                 policy="one_shot"):
    kw = dict(policy=policy, async_write=False, chunk_rows=64,
              num_hosts=num_hosts, keep_latest=10)
    if package == "ref":
        from repro.core import CheckNRunManager as RefManager
        from repro.core import CheckpointConfig as RefConfig
        from repro.core import InMemoryStore as RefStore
        from repro.core import Snapshot as RefSnapshot
        store = store if store is not None else RefStore()
        mgr = RefManager(store, RefConfig(quant=_ref_quant(quant_key), **kw))
        mk = RefSnapshot
    else:
        store = store if store is not None else InMemoryStore()
        mgr = CheckNRunManager(store, CheckpointConfig(
            quant=_port_quant(quant_key), device="cpu", **kw))
        mk = Snapshot
    for s in snaps:
        mgr.save(mk(**s)).result()
    mgr.close()
    return store


def manager(package, store, num_hosts=1):
    if package == "ref":
        from repro.core import CheckNRunManager as RefManager
        from repro.core import CheckpointConfig as RefConfig
        return RefManager(store, RefConfig(async_write=False,
                                           num_hosts=num_hosts))
    return CheckNRunManager(store, CheckpointConfig(
        async_write=False, device="cpu", num_hosts=num_hosts))


def assert_same_state(a, b):
    assert a.step == b.step
    assert sorted(a.tables) == sorted(b.tables)
    for n in a.tables:
        np.testing.assert_array_equal(a.tables[n], b.tables[n], err_msg=n)
        assert sorted(a.row_state[n]) == sorted(b.row_state[n])
        for k in a.row_state[n]:
            np.testing.assert_array_equal(a.row_state[n][k], b.row_state[n][k])
    assert sorted(a.dense) == sorted(b.dense)
    for k in a.dense:
        np.testing.assert_array_equal(a.dense[k], b.dense[k], err_msg=k)


@pytest.mark.parametrize("quant_key", ["none", "u8", "a4"])
@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_four_host_store_restores_across_packages(quant_key, writer, reader):
    store = save_sharded(writer, quant_key, sharded_snapshots(seed=1))
    assert mf.load(store, 1).layout["num_hosts"] == 4
    for step in (1, 2):
        wm, rm = manager(writer, store), manager(reader, store)
        assert_same_state(wm.restore(step), rm.restore(step))
        wm.close()
        rm.close()


def _chunks(store):
    return {k: store.get(k) for k in store.list("chunks/")}


@pytest.mark.parametrize("quant_key", ["none", "u8"])
def test_sharded_chunk_objects_byte_identical(quant_key):
    from repro.core import manifest as ref_mf

    snaps = sharded_snapshots()
    a = save_sharded("ref", quant_key, snaps)
    b = save_sharded("port", quant_key, snaps)
    ca, cb = _chunks(a), _chunks(b)
    assert sorted(ca) == sorted(cb)
    assert any("/host_0003/" in k for k in ca)
    assert any(k.startswith(mf.chunk_prefix(2)) for k in ca)  # the increment
    for k in ca:
        assert ca[k] == cb[k], k
    for step in (1, 2):
        ra, rb = ref_mf.load(a, step), mf.load(b, step)
        assert ra.kind == rb.kind and ra.base_step == rb.base_step
        # part manifests carry their creation time, so only the layout
        # and the voting hosts can match
        assert ra.layout == rb.layout
        assert ra.shards["num_hosts"] == rb.shards["num_hosts"] == 4
        assert [p["host"] for p in ra.shards["parts"]] == \
            [p["host"] for p in rb.shards["parts"]]
        for name in ra.tables:
            assert [c.__dict__ for c in ra.tables[name].chunks] == \
                [c.__dict__ for c in rb.tables[name].chunks]
        assert {k: d.crc32 for k, d in ra.dense.items()} == \
            {k: d.crc32 for k, d in rb.dense.items()}
        assert sorted(ref_mf.list_part_hosts(a, step)) == \
            sorted(mf.list_part_hosts(b, step)) == [0, 1, 2, 3]


def test_sharded_adaptive_chunks_within_the_code_bound():
    """4-bit adaptive: the chunk keys and row sets match the reference's,
    scale and zero are allclose, and at most 2e-3 of codes differ (the
    bound the reference's own kernel tests give; f32 ties may flip a
    greedy decision)."""
    from repro.core import manifest as ref_mf
    from repro_torch.core import packing

    snaps = sharded_snapshots(seed=5)
    a = save_sharded("ref", "a4", snaps)
    b = save_sharded("port", "a4", snaps)
    ca, cb = _chunks(a), _chunks(b)
    assert sorted(ca) == sorted(cb)
    diff = total = 0
    for step in (1, 2):
        ra, rb = ref_mf.load(a, step), mf.load(b, step)
        for name, rec in rb.tables.items():
            for xa, xb in zip(ra.tables[name].chunks, rec.chunks):
                assert xa.key == xb.key and xa.n_rows == xb.n_rows
                assert xa.sections == xb.sections and xa.row_range == xb.row_range
                da, db = ca[xa.key], cb[xb.key]
                for sec in ("scale", "zero"):
                    o, n = xb.sections[sec]
                    np.testing.assert_allclose(
                        np.frombuffer(da[o:o + n], np.float16).astype(np.float32),
                        np.frombuffer(db[o:o + n], np.float16).astype(np.float32),
                        rtol=1e-3, atol=1e-3)
                o, n = xb.sections["codes"]
                k = xb.n_rows * rec.dim
                qa = packing.unpack_bits(da[o:o + n], 4, k)
                qb = packing.unpack_bits(db[o:o + n], 4, k)
                diff += int((qa != qb).sum())
                total += k
    assert total > 0 and diff / total <= 2e-3, diff / total
