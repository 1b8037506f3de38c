"""Row-shard layout for sharded multi-host checkpoints.

Only ``row_shard_bounds`` is here: each host owns a contiguous row-shard
of every embedding table. It is canonical in ``core/range_reader.py``,
since the read-side planner inverts the same layout math; this module
keeps the write side's import path.

The reference's logical-axis ``ShardingRules`` and its family rule sets
(``lm_rules``, ``recsys_rules``, ``gnn_rules``) map tensors onto a JAX
device mesh. They are mesh machinery, not checkpoint layout, and are not
ported here: they come with the mesh launcher (ROADMAP A6.5,
``launch/mesh.py``), with the sharded DimeNet forward and the LM cache's
partition specs.
"""

from ..core.range_reader import row_shard_bounds  # noqa: F401

__all__ = ["row_shard_bounds"]
