"""Device selection for the port: ``"cuda"`` means the card, and only the
card; ``on_meta`` builds a model's tensors as shapes without storage."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when a CUDA device is asked for and
    none is present — the port never runs on the CPU in its place."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but torch sees no CUDA "
            f"device; pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def on_meta():
    """Every tensor a torch factory makes inside the block lives on the
    ``meta`` device, whatever ``device=`` it was asked for: shapes and
    dtypes without storage, so a 132 B-parameter model's state is built
    with no memory. Random draws from a CPU ``torch.Generator`` work there
    too; reading a value does not."""
    from torch.overrides import TorchFunctionMode
    from torch.utils._device import _device_constructors

    makers = _device_constructors()

    class _Meta(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = dict(kwargs or {})
            if func in makers:
                kwargs["device"] = "meta"
            return func(*args, **kwargs)

    with _Meta():
        yield
