"""Whole runs of a training cell on the CPU at a size a test can hold (the
harness's look for a card skipped, the program's kernels' plain versions in
their place), once sound and once with each fault the cell can have planted
in the program underneath: ``correct`` has to come out true, then false."""

import dataclasses

import pytest
import torch

from cnr_bench import bench
from cnr_bench.cell import run_cell

SEED = 2**33 + 17


# At these widths and a batch of 256 the sound gaps of bf16 against the
# float32 reference run larger than at the cells' sizes (on the CPU, four
# seeds: loss 0.0003-0.0052, gradient 0.006-0.092, change 0.015-0.107;
# the half-batch fault 0.005-0.15, 0.59-5.0, 0.19-0.32), so the tests hold
# the harness to limits of their own.
TINY_LIMITS = dict(loss_gap=0.01, grad_gap=0.2, change_gap=0.15, code_mismatch=0.0,
                   rows_wrong=0.0, hash_bad=0.0, raw_wrong=0.0)


def tiny(name: str, traffic: str = "train_ckpt"):
    """The configuration at small widths and vocabularies, with the tests'
    limits, and its traffic at a small batch."""
    cfg = bench.load_config(name)
    if name == "dlrm-rm2":
        cfg.update(vocab_sizes=[max(v // 4096, 8) for v in cfg["vocab_sizes"]], embed_dim=16,
                   bot_mlp=[32, 16], top_mlp=[32, 16, 1])
    else:
        cfg.update(vocab_sizes=[max(v // 40960, 8) for v in cfg["vocab_sizes"]], embed_dim=4,
                   cin_layers=[8, 8], mlp=[16, 16])
    cfg["limits"] = dict(TINY_LIMITS)
    mix = bench.load_traffic(traffic)
    mix.update(batch=256)
    if mix["interval_batches"]:
        mix["interval_batches"] = 2
    return cfg, mix


def _run(name="dlrm-rm2", traffic="train_ckpt"):
    cfg, traffic = tiny(name, traffic)
    run = run_cell(cfg, traffic, SEED, 1.0, False, device="cpu", block_rows=100)
    return run, {k for k, (v, lim) in run.checks.items() if not v <= lim}


@pytest.mark.parametrize("name,traffic", [("dlrm-rm2", "train_ckpt"), ("xdeepfm", "train_ckpt"),
                                          ("xdeepfm", "train")])
def test_a_sound_run_is_correct(name, traffic):
    run, failed = _run(name, traffic)
    assert not failed, run.checks
    assert run.steps > 0
    # the save checks run only where the traffic saves
    assert len(run.checks) == (7 if traffic == "train_ckpt" else 3)


def test_a_step_that_returns_its_state_unchanged_fails(monkeypatch):
    from repro_torch.models import dlrm

    def make(*a, **k):
        def step(state, batch):
            loss = torch.tensor(0.6931, dtype=torch.float32)
            return dataclasses.replace(state, step=state.step + 1), dict(loss=loss, accuracy=loss)
        return step

    monkeypatch.setattr(dlrm, "make_sparse_train_step", make)
    run, failed = _run()
    assert "change_gap" in failed
    assert run.checks["change_gap"][0] == pytest.approx(1.0)


def test_half_the_batch_left_out_fails(monkeypatch):
    from repro_torch.models import dlrm

    real = dlrm.make_sparse_train_step

    def make(*a, **k):
        step = real(*a, **k)
        return lambda state, batch: step(state, {n: v[: v.shape[0] // 2] for n, v in batch.items()})

    monkeypatch.setattr(dlrm, "make_sparse_train_step", make)
    _, failed = _run()
    assert {"loss_gap", "grad_gap"} & failed


def test_a_stored_byte_altered_fails(monkeypatch):
    from repro_torch.core.storage import InMemoryStore

    put = InMemoryStore.put

    def altered(self, key, data):
        if key.startswith("chunks/") and len(data) > 8:
            data = bytearray(data)
            data[len(data) // 2] ^= 0x10
        put(self, key, bytes(data))

    monkeypatch.setattr(InMemoryStore, "put", altered)
    _, failed = _run()
    assert "hash_bad" in failed


def test_codes_altered_where_they_are_produced_fail(monkeypatch):
    from repro_torch.kernels.adaptive_quant import ops

    real = ops.quant_pack

    def altered(x, **kw):
        pq = real(x, **kw)
        pq.words[0] ^= 1
        return pq

    monkeypatch.setattr(ops, "quant_pack", altered)
    _, failed = _run()
    assert "code_mismatch" in failed


def test_a_touched_row_left_out_of_an_increment_fails(monkeypatch):
    from repro_torch.core.checkpoint import CheckNRunManager

    real = CheckNRunManager._select_rows

    def select(self, decision, *a, **k):
        sel = real(self, decision, *a, **k)
        return sel[1:] if decision == "incremental" else sel

    monkeypatch.setattr(CheckNRunManager, "_select_rows", select)
    _, failed = _run()
    assert "rows_wrong" in failed
