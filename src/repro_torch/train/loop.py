"""Training loop with integrated Check-N-Run checkpointing, in PyTorch.

Wires together: the reader tier (exact-N lease protocol), the train step
(touched-mask tracking inside), the snapshot adapter, and the
CheckNRunManager (async incremental+quantized checkpoints). Also provides
failure injection for the recovery tests, and shard-only recovery from the
loss of one host (``Trainer.recover_host``, docs/partial_recovery.md): the
failed host's shard is replayed from the store and spliced into live or
rolled-back state.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.bitwidth import BitwidthController
from ..core.checkpoint import CheckNRunManager, CheckpointConfig
from ..core.reader_protocol import ReaderLease, ReaderState
from ..core.storage import ObjectStore
from ..data.reader import DataReader
from ..train.state import (
    TrainState,
    restore_train_state,
    splice_shard_state,
    state_to_snapshot,
)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    use_reader_tier: bool = True


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """Host arrays to tensors on ``device``; a tensor (an LM decode batch's
    cache, made on the device) moves only if it lies elsewhere, and a dict
    of them is taken key by key."""
    def move(v):
        if isinstance(v, dict):
            return {k: move(x) for k, x in v.items()}
        if isinstance(v, torch.Tensor):
            return v.to(device)
        return torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return {k: move(v) for k, v in batch.items()}


class Trainer:
    def __init__(self, bundle, store: ObjectStore, ckpt_cfg: CheckpointConfig,
                 trainer_cfg: Optional[TrainerConfig] = None,
                 batch_fn: Optional[Callable[[int], Dict[str, np.ndarray]]] = None,
                 bitwidth: Optional[BitwidthController] = None):
        from ..data.cells import batch_for_cell

        self.bundle = bundle
        self.cfg = trainer_cfg or TrainerConfig()
        self.ckpt_cfg = ckpt_cfg
        self.manager = CheckNRunManager(store, ckpt_cfg, bitwidth=bitwidth)
        self.batch_fn = batch_fn or (lambda i: batch_for_cell(bundle, i))
        self.lease = ReaderLease(ckpt_cfg.interval_batches)
        self.reader: Optional[DataReader] = None
        self.state: Optional[TrainState] = None
        self.history: List[Dict[str, float]] = []
        self.stall_times: List[float] = []
        # last 2 checkpoint-boundary snapshots, keyed by step — host-side
        # arrays (take_snapshot copies off the device, so they alias
        # nothing the next step updates). Exact-mode partial recovery rolls
        # SURVIVORS back from these for free: zero bytes fetched, only the
        # failed shard is replayed from the store.
        self._boundary_snaps: Dict[int, Any] = {}
        # restore provenance to stamp into the next save's manifest extra
        # ("degraded_from"): set when a restore/recovery fell back past the
        # step we asked for, so `ckpt show` can surface the lineage gap
        self._provenance: Optional[Dict[str, Any]] = None
        self.last_recovery: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------ lifecycle
    def init_or_restore(self) -> int:
        """Restore from the latest valid checkpoint if one exists."""
        template = self.bundle.make_state()
        try:
            restored = self.manager.restore()
        except FileNotFoundError:
            self.state = template
            start_batch = 0
        else:
            self.state = restore_train_state(template, restored,
                                             self.bundle.tracked)
            start_batch = restored.extra.get("reader", {}).get("next_batch",
                                                               int(restored.step))
            if restored.degraded_from is not None:
                self._provenance = {
                    "requested_step": restored.degraded_from,
                    "restored_step": int(restored.step),
                    "reason": "corrupt-chain fallback"}
        if self.cfg.use_reader_tier:
            self.reader = DataReader(
                self.batch_fn, lease=self.lease,
                state=ReaderState(next_batch=start_batch))
            self.lease.set_limit(start_batch + self.ckpt_cfg.interval_batches)
        return start_batch

    def _next_batch(self, i: int):
        if self.reader is not None:
            return self.reader.next()
        return self.batch_fn(i)

    # ------------------------------------------------------------- training
    def run(self, n_steps: Optional[int] = None,
            fail_at_step: Optional[int] = None) -> TrainState:
        """Train; optionally raise a simulated failure at a given step."""
        n_steps = n_steps or self.cfg.total_steps
        start = int(self.state.step)
        interval = self.ckpt_cfg.interval_batches
        for i in range(start, start + n_steps):
            if fail_at_step is not None and i == fail_at_step:
                raise SimulatedFailure(f"injected failure at step {i}")
            batch = batch_to_device(self._next_batch(i), self.bundle.device)
            self.state, metrics = self.bundle.step_fn(self.state, batch)
            if (i + 1) % interval == 0:
                self.checkpoint()
            if (i + 1) % self.cfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
                m["step"] = i + 1
                self.history.append(m)
        return self.state

    def checkpoint(self) -> None:
        """§3.4 workflow: stall→snapshot, resume, optimize+store in background."""
        extra = {}
        if self.reader is not None:
            # reader has delivered exactly `interval` batches — no in-flight gap
            assert self.reader.in_flight() == 0, "reader-trainer gap!"
            extra["reader"] = self.reader.checkpoint_state().to_dict()
        if self._provenance is not None:
            extra["degraded_from"] = self._provenance
            self._provenance = None
        t0 = time.monotonic()
        snap = state_to_snapshot(self.state, self.bundle.tracked, extra)
        self.stall_times.append(time.monotonic() - t0)
        # retain the two most recent boundary snapshots for exact-mode
        # partial recovery (the previous boundary matters when the save at
        # THIS boundary is the one that dies uncommitted)
        self._boundary_snaps[snap.step] = snap
        for s in sorted(self._boundary_snaps)[:-2]:
            del self._boundary_snaps[s]
        # training may continue: fresh touched masks (new tensors, never an
        # in-place zeroing) and a renewed reader lease for the next interval
        self.state = dataclasses.replace(
            self.state,
            touched={k: torch.zeros_like(v) for k, v in self.state.touched.items()})
        if self.reader is not None:
            self.lease.renew()
        fut = self.manager.save(snap)
        if not self.ckpt_cfg.async_write:
            # synchronous saves park their exception in the returned
            # future; surface it HERE, at the boundary that failed
            fut.result()

    # ------------------------------------------------------ partial recovery
    def _reset_reader(self, start_batch: int) -> None:
        """Rebuild the reader tier at a rolled-back batch cursor (the old
        lease/reader pair may be mid-interval and cannot be rewound)."""
        if not self.cfg.use_reader_tier:
            return
        if self.reader is not None:
            self.reader.close()
        self.lease = ReaderLease(self.ckpt_cfg.interval_batches)
        self.reader = DataReader(self.batch_fn, lease=self.lease,
                                 state=ReaderState(next_batch=start_batch))
        self.lease.set_limit(start_batch + self.ckpt_cfg.interval_batches)

    def recover_host(self, host: int, mode: str = "exact",
                     step: Optional[int] = None,
                     supervisor=None,
                     num_hosts: Optional[int] = None) -> int:
        """Recover from the loss of ONE host's shard without restarting the
        survivors (docs/partial_recovery.md). Replays only that host's
        shard chain from the committed checkpoint, splices it into a
        rebuilt/live TrainState, re-fences touched + optimizer bookkeeping
        for the shard, and resets the reader tier. Returns the step
        training resumes from.

        Staleness policy:

        * ``exact`` — survivors ALSO roll back to the committed step, from
          the retained in-memory boundary snapshot (zero store bytes);
          the resumed run is bit-identical to a never-failed run when the
          checkpoint is unquantized and the train step is deterministic
          (on the CPU; on a card the sparse step's ``index_add_`` adds in
          no fixed order). Falls back to a full restore when the boundary
          snapshot is not retained (e.g. a fresh process).
        * ``cpr`` — survivors keep their LIVE state; only the failed
          shard's rows are overwritten with the committed (stale) values,
          per CPR's partial-staleness model. Training resumes from the
          live step with no lost work on survivors.

        Either way, an unrecoverable shard degrades to a full
        ``restore()`` (kind == "full" in ``last_recovery``) — everything
        rolls back and the degradation is stamped into the next save's
        manifest as ``degraded_from``.

        ``num_hosts`` recovers the host's shard under a NEW layout
        (docs/resharding.md): a trainer restarted at N±k hosts — whose
        own ``ckpt_cfg.num_hosts`` already names the new layout — can
        default it, since the range planner reads the chain regardless of
        the layout it was written under; pass it explicitly to recover a
        shard of a layout differing from the trainer's config.
        """
        from ..core import manifest as mf
        from ..dist.recovery import RecoverySupervisor

        if mode not in ("exact", "cpr"):
            raise ValueError(f"unknown staleness mode {mode!r}")
        tgt = num_hosts if num_hosts is not None \
            else (self.ckpt_cfg.num_hosts
                  if self.ckpt_cfg.num_hosts > 1 else None)
        sup = supervisor or RecoverySupervisor(
            self.manager.store, tgt or self.ckpt_cfg.num_hosts)
        committed = step if step is not None \
            else mf.latest_step(self.manager.store)
        if committed is None:
            raise FileNotFoundError("no committed checkpoint to recover from")
        rs = sup.recover(self.manager, host, step=committed, num_hosts=tgt)
        info = dict(rs.extra.get("recovery", {}))
        info["mode"] = mode

        if info.get("kind") == "full":
            # shard chain unrecoverable — O(model) fallback; restore()
            # already resynced the manager's policy + masks
            self.state = restore_train_state(self.bundle.make_state(), rs,
                                             self.bundle.tracked)
            self._provenance = {
                "requested_host": host,
                "restored_step": int(rs.step),
                "reason": rs.extra.get("recovery_fallback_reason",
                                       "full-restore fallback")}
            self._reset_reader(rs.extra.get("reader", {})
                               .get("next_batch", int(rs.step)))
            self.last_recovery = info
            return int(rs.step)

        ranges = rs.extra["shard"]["row_range"]
        if mode == "cpr":
            self.state = splice_shard_state(self.state, rs,
                                            self.bundle.tracked)
            self.manager.refence_shard(ranges)
            self.last_recovery = info
            return int(self.state.step)

        # exact: rebuild survivors from the retained boundary snapshot
        # (already host-side arrays at exactly the committed step), then
        # splice the failed shard from what the store replayed
        base = self._boundary_snaps.get(int(rs.step))
        if base is None:
            full = self.manager.restore(int(rs.step),
                                        on_corruption="fallback")
            self.manager._count(recoveries_full_total=1,
                                last_recovery_host=host)
            info["kind"] = "full"
            self.state = restore_train_state(self.bundle.make_state(), full,
                                             self.bundle.tracked)
            self._reset_reader(full.extra.get("reader", {})
                               .get("next_batch", int(full.step)))
            self.last_recovery = info
            return int(full.step)
        self.state = restore_train_state(self.bundle.make_state(),
                                         _SnapshotRestored(base),
                                         self.bundle.tracked)
        self.state = splice_shard_state(self.state, rs, self.bundle.tracked)
        self.manager.resync_from(int(rs.step))
        self._reset_reader(base.extra.get("reader", {})
                           .get("next_batch", int(rs.step)))
        self.last_recovery = info
        return int(rs.step)

    def close(self) -> None:
        if self.reader is not None:
            self.reader.close()
        self.manager.close()


class _SnapshotRestored:
    """Adapter presenting a boundary Snapshot through the RestoredState
    attributes ``restore_train_state`` reads (tables / row_state / dense /
    step) — the snapshot's dense dict already carries "step" and "rng"."""

    def __init__(self, snap) -> None:
        self.step = snap.step
        self.tables = snap.tables
        self.row_state = snap.row_state
        self.dense = snap.dense
        self.extra = snap.extra
        self.degraded_from = None


class SimulatedFailure(RuntimeError):
    pass
