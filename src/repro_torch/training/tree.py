"""Param trees (nested dicts, lists and tuples of tensors) walked as the
reference walks them — dict keys sorted, sequences in order — with a
leaf's key written as ``jax.tree_util.keystr`` writes it
(``['layers'][0]['w_x']``), so the checkpoints of both packages name their
arrays alike. ``leaves`` / ``unflatten`` are the serving runtime's."""
from __future__ import annotations

from ..serving.runtime import leaves, unflatten

__all__ = ["leaves", "leaves_with_keys", "unflatten", "tree_map"]


def leaves_with_keys(tree, prefix: str = "") -> list:
    """[(key, leaf)] in ``leaves`` order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in leaves_with_keys(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in leaves_with_keys(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    flat = [leaves(t) for t in (tree,) + rest]
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
