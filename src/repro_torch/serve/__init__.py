"""Checkpoint-as-a-service (docs/serving.md): publisher/subscriber layer
over the manifest chain for online training.

* ``delta_index`` — the commit-time touched-row summary stamped into
  manifests, and its lazy version-0 derivation for legacy chains.
* ``subscriber`` — :class:`CheckpointSubscriber`: polls a store (local or
  in-memory), plans the minimal catch-up via the range planner, and
  streams fetch→decode→apply into an embedding server.
* ``server`` — :class:`EmbeddingServer`: in-memory double-buffered tables;
  concurrent lookups never observe a partially applied step.

Attribute access is lazy (PEP 562): ``repro_torch.core.checkpoint``
imports ``repro_torch.serve.delta_index`` at module scope, which executes
THIS package init mid-core-import — eagerly importing
``subscriber``/``server`` here (the subscriber imports ``repro_torch.core``)
would cycle.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "DELTA_VERSION": ".delta_index",
    "build_delta": ".delta_index",
    "catchup_cost": ".delta_index",
    "compress_spans": ".delta_index",
    "delta_of": ".delta_index",
    "merge_spans": ".delta_index",
    "touched_union": ".delta_index",
    "EmbeddingServer": ".server",
    "PinnedView": ".server",
    "CheckpointSubscriber": ".subscriber",
    "ManifestCache": ".subscriber",
    "SubscriberHealth": ".subscriber",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod, __name__), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
