"""The tensor- and sequence-parallel layout of one rank of a (data, model)
mesh for an LM train step, read off the sharding rules' gates.

Under ``lm_rules`` a rank of ``model`` index j holds its slice of every
leaf whose logical axis shards over ``model`` (heads, kv heads, ff,
vocabulary, experts) and its data shard of the batch. Between blocks the
residual is the rank's sequence slice (B/DATA, S/MODEL, d) where ``seq_sp``
divides the sequence (Megatron's sequence parallelism), else the whole
sequence, the same on every ``model`` rank. A block's model-parallel
region (heads, ff columns, experts) enters through ``enter`` and leaves
through ``leave``:

  * sequence-parallel: ``enter`` all-gathers the normed slices over
    ``model`` (backward: a reduce-scatter, which sums the ranks' partial
    cotangents), ``leave`` reduce-scatters the row-parallel partial sums
    back to the slice (backward: an all-gather);
  * otherwise: ``enter`` is ``group_ops.copy_to`` (identity forward,
    all-reduce backward), ``leave`` an all-reduce whose backward passes
    the cotangent through (Megatron's f and g).

A region whose leaves the gates leave replicated (attention when the heads
do not divide, an FFN whose ff does not) runs whole on every rank: under
sequence parallelism attention reads the whole sequence (``whole``) and
keeps the rank's own query positions (``own``), and a position-wise FFN
runs on the slice alone.

``world`` is the group of the batch's axes and ``model`` (a ``pod`` axis
that the batch does not split holds replicas, which sum nothing). The loss
is one global loss, held by every rank: every collective's
backward is chosen so that each rank holds the whole cotangent of what it
holds (its slice, or a replicated tensor), and a parameter's gradient on
a rank is that rank's part of the global gradient. Which ranks' parts sum
to the whole is ``configs._families.lm_grad_axes``'.

Collectives over a group of one rank are skipped, so a mesh axis of size 1
issues none.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .group_ops import all_gather, all_reduce, copy_to, group_size, reduce_scatter


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One rank's layout: its groups, its ``model`` index ``j`` of ``n``,
    and the gates (``sp``: the residual is the sequence slice; ``heads``,
    ``kv``, ``ff``, ``vocab``, ``experts``: those axes shard over
    ``model``)."""

    rules: object
    model: object
    data: object
    world: object
    n: int
    j: int
    n_data: int
    sp: bool
    heads: bool
    kv: bool
    ff: bool
    vocab: bool
    experts: bool

    # ---------------------------------------------------------- sequence
    def own(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The rank's sequence slice of a whole-sequence ``x``, or ``x``
        itself without sequence parallelism."""
        if not self.sp or self.n == 1:
            return x
        s = x.shape[dim] // self.n
        return x.narrow(dim, self.j * s, s)

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """The whole sequence of a residual-layout ``x`` (B, S_l, ...), for a
        region that runs whole on every rank: the slices all-gathered, or
        ``x`` itself without sequence parallelism (every rank holds it and
        computes the same, so no cotangent needs summing)."""
        if not self.sp or self.n == 1:
            return x
        return all_gather(x, self.model, dim=1)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """A model-parallel region's input: the whole sequence, whose
        cotangent is the sum of the ranks' partial ones."""
        if self.n == 1:
            return x
        if self.sp:
            return all_gather(x, self.model, dim=1)
        return copy_to(x, self.model)

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        """The sum over ``model`` of a region's partial output (B, S, ...),
        in the residual's layout."""
        if self.n == 1:
            return y
        if self.sp:
            return reduce_scatter(y, self.model, dim=1)
        return all_reduce(y, self.model, backward="identity")

    # ------------------------------------------------------------ heads
    def head_range(self, heads: int):
        """(first, count) of the rank's q heads of ``heads``."""
        if not self.heads:
            return 0, heads
        return self.j * (heads // self.n), heads // self.n

    def kv_heads(self, heads: int, kv_heads: int):
        """(first kv head, kv heads, index) for the rank's q heads where the
        kv heads are replicated: the kv heads its q heads attend to (q head
        h to kv head h // (heads / kv_heads), as ``chunked_attention``
        groups them), and None when those q heads fall on them in whole
        groups, else each q head's kv head among them, in order."""
        group = heads // kv_heads
        lo, count = self.head_range(heads)
        kv_lo, kv_hi = lo // group, (lo + count - 1) // group + 1
        index = [(lo + t) // group - kv_lo for t in range(count)]
        per = count // (kv_hi - kv_lo)
        if count % (kv_hi - kv_lo) == 0 and index == [t // per for t in range(count)]:
            return kv_lo, kv_hi, None
        return kv_lo, kv_hi, index

    # ------------------------------------------------------------- sums
    def sum_over(self, x: torch.Tensor, spread: bool) -> torch.Tensor:
        """One global value from each rank's part ``x``, every rank holding
        it, its cotangent passed through: summed over the world where the
        ``model`` ranks hold different parts (``spread``), else over
        ``data``."""
        group = self.world if spread else self.data
        if group_size(group) == 1:
            return x
        return all_reduce(x, group, backward="identity")


def tensor_parallel(rules, cfg, seq: int) -> Optional[TensorParallel]:
    """The layout of this rank under ``rules`` for an LM config ``cfg`` at
    sequence length ``seq``; None without a mesh that carries a process
    group (one device)."""
    mesh = getattr(rules, "mesh", None)
    if mesh is None or not getattr(mesh, "has_group", False):
        return None
    if "d_model" in rules.axis_map:
        raise ValueError("pure-FSDP rules (a config's pure_fsdp_train: d_model over "
                         "model) have no step in the port; no registered config sets it "
                         "(minicpm3-4b's attempt was refuted in the reference)")
    batch_axes = tuple(rules.axis_map["batch"])
    n = mesh.shape.get("model", 1)

    def splits(name, size):
        return n > 1 and rules.axes_for(name, size) == ("model",)

    heads = splits("heads", cfg.n_heads)
    return TensorParallel(
        rules=rules, model=mesh.group_for(("model",)), data=mesh.group_for(batch_axes),
        world=mesh.group_for(batch_axes + ("model",)), n=n, j=mesh.axis_index("model"),
        n_data=group_size(mesh.group_for(batch_axes)),
        sp=splits("seq_sp", seq), heads=heads,
        kv=heads and not cfg.mla and splits("kv_heads", cfg.n_kv_heads),
        ff=cfg.moe is None and splits("ff", cfg.d_ff), vocab=splits("vocab", cfg.vocab),
        experts=cfg.moe is not None and splits("experts", cfg.moe.n_experts))


__all__ = ["TensorParallel", "tensor_parallel"]
