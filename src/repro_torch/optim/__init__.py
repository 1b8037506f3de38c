from .optimizers import (
    Optimizer,
    adagrad,
    apply_updates,
    rowwise_adagrad,
    split_optimizer,
)

__all__ = [k for k in dir() if not k.startswith("_")]
