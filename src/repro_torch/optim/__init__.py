from .optimizers import (
    Optimizer,
    adagrad,
    adamw,
    apply_updates,
    rowwise_adagrad,
    sgd,
    split_optimizer,
)

__all__ = [k for k in dir() if not k.startswith("_")]
