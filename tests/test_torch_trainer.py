"""The slice whole, on the CPU: the port's Trainer on reduced dlrm-rm2 with
Check-N-Run checkpoints, an injected failure and a restore, held against
the reference package's manager and its own integrity scan."""

import numpy as np
import pytest
import torch

from repro.core import CheckNRunManager as RefManager
from repro.core import CheckpointConfig as RefConfig
from repro.core import LocalFSStore as RefLocalFSStore
from repro_torch.configs import get_cell
from repro_torch.core import CheckpointConfig, InMemoryStore, LocalFSStore, PAPER_DEFAULTS
from repro_torch.core.integrity import scan_store
from repro_torch.core.snapshot import take_snapshot
from repro_torch.train.loop import SimulatedFailure, Trainer, TrainerConfig


@pytest.fixture(scope="module")
def bundle():
    return get_cell("dlrm-rm2", "train_batch", reduced=True, device="cpu")


def _cfg(quant):
    return CheckpointConfig(interval_batches=2, policy="intermittent",
                            quant=quant, device="cpu")


def _tables(state):
    return {k: v.numpy().copy() for k, v in state.params["tables"].items()}


def test_fail_restore_resume_and_cross_package_restore(bundle, tmp_path):
    cfg = _cfg(PAPER_DEFAULTS[4])
    t1 = Trainer(bundle, LocalFSStore(str(tmp_path)), cfg, TrainerConfig(total_steps=6))
    assert t1.init_or_restore() == 0
    with pytest.raises(SimulatedFailure):
        t1.run(6, fail_at_step=5)
    t1.close()

    t2 = Trainer(bundle, LocalFSStore(str(tmp_path)), cfg,
                 TrainerConfig(total_steps=6, log_every=1))
    assert t2.init_or_restore() == 4
    restored = _tables(t2.state)

    ref = RefManager(RefLocalFSStore(str(tmp_path)), RefConfig(async_write=False))
    rs = ref.restore()
    ref.close()
    assert rs.step == 4
    for name, t in restored.items():
        np.testing.assert_array_equal(rs.tables[name], t, err_msg=name)
        np.testing.assert_array_equal(rs.row_state[name]["opt_acc"],
                                      t2.state.opt_state["tables"][name].numpy())
    assert scan_store(LocalFSStore(str(tmp_path))).ok

    t2.run(2)
    t2.close()
    assert [h["step"] for h in t2.history] == [5, 6]
    assert all(np.isfinite(h["loss"]) for h in t2.history)


def test_unquantized_resume_is_bitwise_the_uninterrupted_run(bundle, tmp_path):
    ref_run = Trainer(bundle, LocalFSStore(str(tmp_path / "a")), _cfg(None),
                      TrainerConfig(total_steps=6))
    ref_run.init_or_restore()
    want = ref_run.run(6)
    ref_run.close()

    cfg = _cfg(None)
    t1 = Trainer(bundle, LocalFSStore(str(tmp_path / "b")), cfg, TrainerConfig())
    t1.init_or_restore()
    with pytest.raises(SimulatedFailure):
        t1.run(6, fail_at_step=5)
    t1.close()
    t2 = Trainer(bundle, LocalFSStore(str(tmp_path / "b")), cfg, TrainerConfig())
    assert t2.init_or_restore() == 4
    got = t2.run(2)
    t2.close()
    assert got.step == want.step == 6
    for name, t in _tables(want).items():
        np.testing.assert_array_equal(_tables(got)[name], t, err_msg=name)


def test_snapshot_survives_an_in_place_update(bundle):
    """On the CPU ``tensor.numpy()`` shares memory with the tensor; the
    snapshot must hold a private copy, or the next step's in-place table
    update would corrupt a snapshot still being written."""
    state = bundle.make_state()
    table = state.params["tables"]["emb_0"]
    before = table.clone()
    snap = take_snapshot(step=0, tables={"emb_0": table},
                         row_state={"emb_0": {"opt_acc": state.opt_state["tables"]["emb_0"]}},
                         touched={"emb_0": state.touched["emb_0"]},
                         dense={"w": state.params["dense"]["bot"][0]["w"]}, extra={})
    with torch.no_grad():
        table.add_(1.0)
        state.opt_state["tables"]["emb_0"].add_(1.0)
        state.params["dense"]["bot"][0]["w"].add_(1.0)
    np.testing.assert_array_equal(snap.tables["emb_0"], before.numpy())
    assert (snap.row_state["emb_0"]["opt_acc"] == 0).all()
    assert not np.shares_memory(snap.dense["w"], state.params["dense"]["bot"][0]["w"].numpy())


def test_checkpoint_gives_fresh_touched_masks(bundle):
    """The masks the snapshot was taken from are replaced, not zeroed in
    place."""
    tr = Trainer(bundle, InMemoryStore(), CheckpointConfig(
        interval_batches=2, quant=None, async_write=False, device="cpu"),
        TrainerConfig(total_steps=2, use_reader_tier=False))
    tr.init_or_restore()
    tr.run(1)
    held = dict(tr.state.touched)
    assert any(bool(m.any()) for m in held.values())
    tr.checkpoint()
    for name, m in tr.state.touched.items():
        assert m is not held[name] and not bool(m.any())
    assert any(bool(m.any()) for m in held.values())
    tr.close()
