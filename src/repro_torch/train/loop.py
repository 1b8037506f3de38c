"""Training loop with integrated Check-N-Run checkpointing, in PyTorch.

Wires together: the reader tier (exact-N lease protocol), the train step
(touched-mask tracking inside), the snapshot adapter, and the
CheckNRunManager (async incremental+quantized checkpoints). Also provides
failure injection for the recovery tests. Shard-only recovery
(``recover_host``) comes with the partial-recovery slice.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.bitwidth import BitwidthController
from ..core.checkpoint import CheckNRunManager, CheckpointConfig
from ..core.reader_protocol import ReaderLease, ReaderState
from ..core.storage import ObjectStore
from ..data.reader import DataReader
from ..train.state import TrainState, restore_train_state, state_to_snapshot


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    use_reader_tier: bool = True


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


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
        # restore provenance to stamp into the next save's manifest extra
        # ("degraded_from"): set when a restore fell back past the step we
        # asked for, so `ckpt show` can surface the lineage gap
        self._provenance: Optional[Dict[str, object]] = None

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

    def close(self) -> None:
        if self.reader is not None:
            self.reader.close()
        self.manager.close()


class SimulatedFailure(RuntimeError):
    pass
