"""The store format is the contract between the reference and the port.

The same numpy snapshots are saved by the reference's CheckNRunManager and
by the port's (``device="cpu"``): chunk objects must be byte-identical for
unquantized and 8-bit uniform_asym checkpoints (and, on these inputs, for
4-bit adaptive), over a full save and an incremental one; a store written
by either package must restore in the other to the tables, aux and dense
arrays the writer's own restore gives.
"""

import numpy as np
import pytest

from repro.core import CheckNRunManager as RefManager
from repro.core import CheckpointConfig as RefConfig
from repro.core import InMemoryStore as RefStore
from repro.core import PAPER_DEFAULTS as REF_DEFAULTS
from repro.core import Snapshot as RefSnapshot
from repro.core import manifest as ref_mf
from repro.core.integrity import scan_store as ref_scan_store
from repro_torch.core import CheckNRunManager, CheckpointConfig, InMemoryStore
from repro_torch.core import PAPER_DEFAULTS, Snapshot
from repro_torch.core import manifest as mf
from repro_torch.core.integrity import scan_store

QUANT = {"none": (None, None), "u8": (REF_DEFAULTS[8], PAPER_DEFAULTS[8]),
         "a4": (REF_DEFAULTS[4], PAPER_DEFAULTS[4])}


def _snapshots(seed=0):
    """A full-save snapshot and an incremental one (steps 1 and 2), as
    numpy arrays shared by both packages."""
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


def _save(package, quant_key, snaps, store=None):
    ref_q, port_q = QUANT[quant_key]
    kw = dict(policy="one_shot", async_write=False, chunk_rows=128)
    if package == "ref":
        store = store or RefStore()
        mgr = RefManager(store, RefConfig(quant=ref_q, **kw))
        mk = RefSnapshot
    else:
        store = store or InMemoryStore()
        mgr = CheckNRunManager(store, CheckpointConfig(quant=port_q, device="cpu", **kw))
        mk = Snapshot
    for s in snaps:
        mgr.save(mk(**s)).result()
    mgr.close()
    return store


def _restore(package, store, step=None):
    if package == "ref":
        mgr = RefManager(store, RefConfig(async_write=False))
    else:
        mgr = CheckNRunManager(store, CheckpointConfig(async_write=False, device="cpu"))
    rs = mgr.restore(step)
    mgr.close()
    return rs


def _chunks(store):
    return {k: store.get(k) for k in store.list("chunks/")}


@pytest.mark.parametrize("quant_key", ["none", "u8", "a4"])
def test_chunk_objects_byte_identical(quant_key):
    """For 4-bit adaptive the contract only asks for the adaptive tolerance
    (ties may flip a greedy decision); on the CPU, with these inputs, the
    port's bytes are the reference's exactly, and this test holds them so."""
    snaps = _snapshots()
    ref_store = _save("ref", quant_key, snaps)
    port_store = _save("port", quant_key, snaps)
    a, b = _chunks(ref_store), _chunks(port_store)
    assert sorted(a) == sorted(b)
    assert any(k.startswith(mf.chunk_prefix(2)) for k in a)  # the increment
    for k in a:
        assert a[k] == b[k], k
    for step in (1, 2):
        ra, rb = ref_mf.load(ref_store, step), mf.load(port_store, step)
        assert ra.kind == rb.kind and ra.base_step == rb.base_step
        for name in ra.tables:
            assert [c.__dict__ for c in ra.tables[name].chunks] == \
                [c.__dict__ for c in rb.tables[name].chunks]
        assert {k: d.crc32 for k, d in ra.dense.items()} == \
            {k: d.crc32 for k, d in rb.dense.items()}


def _assert_same_state(a, b):
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
def test_restore_across_packages(quant_key, writer, reader):
    store = _save(writer, quant_key, _snapshots(seed=1))
    for step in (1, 2):
        _assert_same_state(_restore(writer, store, step),
                           _restore(reader, store, step))


def test_adaptive_4bit_tables_within_the_quantization_bound():
    full, inc = _snapshots(seed=2)
    store = _save("port", "a4", [full, inc])
    rs = _restore("port", store)
    for n, t in inc["tables"].items():
        err = np.abs(rs.tables[n] - t)
        span = (t.max(axis=1) - t.min(axis=1))[:, None]
        assert (err <= span / 2 + 1e-6).all(), n       # never past the row's range
        assert err.mean() < 0.1 * np.abs(t).mean(), n  # 4-bit: a few % on average
        np.testing.assert_array_equal(rs.row_state[n]["opt_acc"],
                                      inc["row_state"][n]["opt_acc"])


@pytest.mark.parametrize("quant_key", ["u8", "a4"])
def test_fused_pack_and_host_pack_write_the_same_bytes(quant_key):
    """``fused_pack=False`` (codes packed on the host by ``pack_bits``)
    writes the chunks the fused device path writes."""
    snaps = _snapshots(seed=4)

    def run(fused):
        store = InMemoryStore()
        mgr = CheckNRunManager(store, CheckpointConfig(
            policy="one_shot", quant=QUANT[quant_key][1], async_write=False,
            chunk_rows=128, fused_pack=fused, device="cpu"))
        for s in snaps:
            mgr.save(Snapshot(**s)).result()
        mgr.close()
        return _chunks(store)

    assert run(True) == run(False)


def test_port_store_scans_clean_in_both_packages():
    store = _save("port", "a4", _snapshots(seed=3))
    assert scan_store(store).ok
    assert ref_scan_store(store).ok
