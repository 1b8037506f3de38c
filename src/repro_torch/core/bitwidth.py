"""Dynamic quantization bit-width selection (Check-N-Run §5.2.1).

The measured accuracy budget (<0.01% lifetime degradation, Fig. 10) bounds
how many times a job may resume from a quantized checkpoint:

    2-bit : 1 restore      3-bit : 3 restores
    4-bit : 20 restores    8-bit : 100+ restores

Check-N-Run estimates the expected number of failures from the node count,
per-node failure probability (from failure logs) and expected training time,
then picks the narrowest bit-width whose restore budget covers it. If
observed failures exceed the estimate mid-run, it falls back to 8-bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

from .quantize import PAPER_DEFAULTS, QuantConfig

# restore budget per bit-width, from Fig. 10 (a)-(c) + 8-bit text.
RESTORE_BUDGET: Dict[int, int] = {2: 1, 3: 3, 4: 20, 8: 100}


def expected_failures(n_nodes: int, p_node_fail_per_hour: float,
                      expected_train_hours: float) -> float:
    """E[#failures] for a job over its lifetime; failures are per-node
    independent Poisson arrivals (any node failing kills/restarts the job)."""
    rate = n_nodes * p_node_fail_per_hour
    return rate * expected_train_hours


def select_bits(exp_failures: float, safety: float = 1.0) -> int:
    """Narrowest bit-width whose restore budget covers the estimate."""
    need = math.ceil(max(exp_failures, 0.0) * safety)
    for bits in sorted(RESTORE_BUDGET):
        if RESTORE_BUDGET[bits] >= max(need, 1) or bits == 8:
            if RESTORE_BUDGET[bits] >= need:
                return bits
    return 8


@dataclasses.dataclass
class BitwidthController:
    """Tracks restores during a run and widens the bit-width on overrun."""

    n_nodes: int
    p_node_fail_per_hour: float
    expected_train_hours: float
    safety: float = 1.0
    observed_restores: int = 0

    def __post_init__(self) -> None:
        self.estimate = expected_failures(
            self.n_nodes, self.p_node_fail_per_hour, self.expected_train_hours)
        self.bits = select_bits(self.estimate, self.safety)

    def current_config(self) -> QuantConfig:
        return PAPER_DEFAULTS[self.bits]

    def on_restore(self) -> QuantConfig:
        """Record a restore; fall back to 8-bit once the budget is spent."""
        self.observed_restores += 1
        if self.observed_restores >= RESTORE_BUDGET[self.bits]:
            self.bits = 8
        return self.current_config()

    def to_dict(self) -> dict:
        return dict(bits=self.bits, observed_restores=self.observed_restores,
                    estimate=self.estimate)

    def load_dict(self, d: dict) -> None:
        self.bits = d["bits"]
        self.observed_restores = d["observed_restores"]
