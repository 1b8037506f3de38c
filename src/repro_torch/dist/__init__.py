"""Sharded multi-host checkpointing in PyTorch: per-host shard writers
(``repro_torch.dist.shard_writer``), partial recovery
(``repro_torch.dist.recovery``) and the row-shard layout
(``repro_torch.dist.sharding``). Import submodules directly — this package
init stays import-light so the core checkpoint path pays for nothing it
does not use."""
