"""Weights made from the seed, on the device, for the program and the
reference alike.

A configuration's plain reference lists its parameters as ``(path, shape,
scale)``: ``scale`` > 0 draws a normal leaf times ``scale``, 0 a zero leaf.
Every normal leaf is a view of one flat buffer drawn by one ``randn`` call
on a generator seeded with the run's seed, so the same seed gives the same
weights on the same card, and ``make_weights`` can draw them again after
the program has changed its own.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

Spec = Tuple[Tuple, Tuple[int, ...], float]


def make_weights(specs: Sequence[Spec], seed: int, device) -> Dict[Tuple, torch.Tensor]:
    """``{path: leaf}`` (f32) for ``specs``, in their order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    sizes = [_numel(shape) for _, shape, scale in specs if scale]
    flat = torch.randn(sum(sizes), generator=gen, dtype=torch.float32, device=device)
    out, off = {}, 0
    for path, shape, scale in specs:
        if scale:
            n = _numel(shape)
            out[path] = flat[off:off + n].view(shape).mul_(scale)
            off += n
        else:
            out[path] = torch.zeros(shape, dtype=torch.float32, device=device)
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def nest(leaves: Dict[Tuple, torch.Tensor]):
    """A tree of dicts and lists from ``{path: leaf}``: a node whose keys
    are the integers 0..n-1 becomes a list."""
    root: dict = {}
    for path, leaf in leaves.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def fix(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(isinstance(k, int) for k in keys):
            return [fix(node[i]) for i in range(len(keys))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def leaves_of(tree, path: Tuple = ()) -> List[Tuple[Tuple, object]]:
    """``[(path, leaf), ...]`` of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_of(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves_of(v, path + (i,))]
    return [(path, tree)]
