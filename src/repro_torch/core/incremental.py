"""Incremental checkpoint policies (Check-N-Run §4.1).

A policy decides, at each checkpoint interval, whether to write a FULL
checkpoint or an INCREMENT, and which baseline an increment is relative to.

* ``OneShotBaseline``     — full once, then increments vs. that baseline
                            (cumulative touched-since-baseline rows).
* ``ConsecutiveIncrement`` — increments store only rows touched during the
                            last interval; recovery replays the whole chain.
* ``IntermittentBaseline`` — §4.1.1 history-based predictor. With past
                            increment sizes S_1..S_i (fractions of the full
                            size, S_0 = 1), take a FULL checkpoint at interval
                            i+1 iff  F_c = 1 + ΣS_k  <=  I_c = (i+1) * S_i.

Policies are host-side pure-python state machines; sizes are fed back from the
writer (``observe``) so the predictor uses *actual* stored sizes, metadata
included.
"""

from __future__ import annotations

import dataclasses
from typing import List, Literal, Optional

Decision = Literal["full", "incremental"]


@dataclasses.dataclass
class PolicyState:
    """Serializable policy state (stored in the checkpoint manifest)."""

    name: str
    increment_sizes: List[float] = dataclasses.field(default_factory=list)
    baseline_step: Optional[int] = None
    full_size_bytes: Optional[int] = None


class IncrementalPolicy:
    name = "abstract"

    def __init__(self) -> None:
        self.state = PolicyState(name=self.name)

    # -- decision --------------------------------------------------------
    def decide(self, step: int) -> Decision:
        raise NotImplementedError

    # -- feedback ---------------------------------------------------------
    def observe(self, step: int, decision: Decision, nbytes: int) -> None:
        st = self.state
        if decision == "full":
            st.full_size_bytes = nbytes
            st.baseline_step = step
            st.increment_sizes = []
        else:
            denom = max(st.full_size_bytes or nbytes, 1)
            st.increment_sizes.append(nbytes / denom)

    # -- mask semantics ----------------------------------------------------
    @property
    def cumulative_mask(self) -> bool:
        """True if increments are relative to the baseline (mask must
        accumulate since baseline); False if relative to previous ckpt."""
        raise NotImplementedError

    # -- (de)serialization --------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self.state)

    def load_dict(self, d: dict) -> None:
        fields = {f.name for f in dataclasses.fields(PolicyState)}
        self.state = PolicyState(**{k: v for k, v in d.items() if k in fields})


class FullOnly(IncrementalPolicy):
    """No increments — every checkpoint stores the whole model."""

    name = "full_only"
    cumulative_mask = False

    def decide(self, step: int) -> Decision:
        return "full"


class OneShotBaseline(IncrementalPolicy):
    name = "one_shot"
    cumulative_mask = True

    def decide(self, step: int) -> Decision:
        return "full" if self.state.baseline_step is None else "incremental"


class ConsecutiveIncrement(IncrementalPolicy):
    name = "consecutive"
    cumulative_mask = False

    def decide(self, step: int) -> Decision:
        return "full" if self.state.baseline_step is None else "incremental"


class IntermittentBaseline(IncrementalPolicy):
    """§4.1.1 predictor: full iff F_c <= I_c."""

    name = "intermittent"
    cumulative_mask = True

    def decide(self, step: int) -> Decision:
        st = self.state
        if st.baseline_step is None or not st.increment_sizes:
            return "full" if st.baseline_step is None else "incremental"
        i = len(st.increment_sizes)
        f_c = 1.0 + sum(st.increment_sizes)
        i_c = (i + 1) * st.increment_sizes[-1]
        return "full" if f_c <= i_c else "incremental"


POLICIES = {
    p.name: p
    for p in (FullOnly, OneShotBaseline, ConsecutiveIncrement, IntermittentBaseline)
}


def make_policy(name: str) -> IncrementalPolicy:
    try:
        return POLICIES[name]()
    except KeyError:
        raise ValueError(f"unknown incremental policy {name!r}; have {sorted(POLICIES)}")
