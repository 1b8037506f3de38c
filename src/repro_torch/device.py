"""Device selection for the port: ``"cuda"`` means the card, and only the card."""

from __future__ import annotations

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
