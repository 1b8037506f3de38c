"""Nested dict/list/tuple containers of tensors, walked as JAX walks pytrees.

The port keeps the reference's parameter trees (``{"tables": {...},
"dense": {"bot": [{"w", "b"}, ...], ...}}``) as plain containers. Leaves are
visited in JAX's order (dict keys sorted), and :func:`keystr` spells a path
exactly as ``jax.tree_util.keystr`` does, so the dense snapshot keys match
the reference's byte for byte (``params['bot'][0]['w']``).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]


def _children(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def keystr(path: Path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys and sequence indices."""
    return "".join(f"[{k!r}]" for k in path)


def flatten_with_path(tree, path: Path = ()) -> List[Tuple[Path, Any]]:
    """``[(path, leaf), ...]`` in JAX's leaf order."""
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    for k, sub in kids:
        out.extend(flatten_with_path(sub, path + (k,)))
    return out


def map_with_path(fn: Callable[[Path, Any], Any], tree, path: Path = ()):
    """A tree of the same structure with ``fn(path, leaf)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
