"""Sharded multi-host checkpointing in PyTorch: per-host shard writers
(``repro_torch.dist.shard_writer``), partial recovery
(``repro_torch.dist.recovery``) and the row-shard layout
(``repro_torch.dist.sharding``, imported here as the reference's package
exposes it). Import the other submodules directly."""

from . import sharding  # noqa: F401
