from .loop import SimulatedFailure, Trainer, TrainerConfig
from .state import (
    TrackedSpec,
    TrainState,
    init_train_state,
    restore_train_state,
    state_from_numpy,
    state_to_snapshot,
)

__all__ = [k for k in dir() if not k.startswith("_")]
