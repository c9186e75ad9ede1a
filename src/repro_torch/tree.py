"""Trees of tensors as the port lays them out: dicts, lists and tuples, with
``None`` for an empty subtree (the reference's pytrees).

``leaves`` and ``leaves_with_path`` walk a tree in ``jax.tree_util``'s
order: a dict's keys sorted, a list's items in order, ``None`` skipped. A
Python dict iterates in insertion order instead, so anything that folds
over leaves (``optim.clip_by_global_norm``'s sum of squares) or names them
(``checkpoint``'s archive keys) goes through here to match the reference.
``map`` keeps the first tree's structure and key order.
"""

from __future__ import annotations

__all__ = ["leaves", "leaves_with_path", "map", "path_str"]

_SEP = "::"


def leaves_with_path(tree, path: tuple = ()) -> list:
    """[(path, leaf)] in ``jax.tree_util``'s order; a path is a tuple of
    dict keys and list indices."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for key in sorted(tree) for item in leaves_with_path(tree[key],
                                                                        path + (key,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, sub in enumerate(tree)
                for item in leaves_with_path(sub, path + (i,))]
    return [(path, tree)]


def leaves(tree) -> list:
    """The leaves in ``jax.tree_util.tree_leaves``' order."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def map(fn, tree, *rest):  # noqa: A001 - the reference's tree_map
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``; ``None`` subtrees stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: map(fn, sub, *(r[key] for r in rest)) for key, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map(fn, sub, *(r[i] for r in rest)) for i, sub in enumerate(tree)]
    return fn(tree, *rest)


def path_str(path: tuple) -> str:
    """A path as the reference's checkpoint names it: each part as
    ``jax.tree_util.keystr`` writes it, joined by ``::``, e.g.
    ``['blocks']::[0]::['mixer']::['wq']``."""
    return _SEP.join(f"[{part!r}]" for part in path)
