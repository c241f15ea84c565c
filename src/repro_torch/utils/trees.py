"""Parameter trees: lists, tuples (named or not) and dicts of tensors.

Leaves are ordered as `jax.tree.leaves` orders them: dict keys sorted,
lists and tuples in order, ``None`` an empty subtree.  The MLP's
``[{"w", "b"}, ...]`` therefore flattens as ``b0, w0, b1, w1``.
`torch.utils._pytree` keeps dict insertion order (``w`` before ``b``), so
every per-leaf vector, counter and test in this package indexes leaves
through these helpers instead.
"""
from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree) -> List[Any]:
    """The leaves of `tree` in JAX order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for sub in tree for l in leaves(sub)]
    return [tree]


def same_structure(a, b) -> bool:
    """Whether `a` and `b` are trees of one structure, as JAX compares tree
    structures: the same containers and dict keys, leaves in the same
    places (a leaf's own type and shape are not compared)."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and sorted(a) == sorted(b)
                and all(same_structure(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same_structure(x, y) for x, y in zip(a, b)))
    return True


def tree_map(fn: Callable, tree, *rest):
    """Apply `fn` leaf by leaf over trees of one structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        subs = [tree_map(fn, *parts) for parts in zip(tree, *rest)]
        if hasattr(tree, "_fields"):          # NamedTuple
            return type(tree)(*subs)
        return type(tree)(subs)
    return fn(tree, *rest)


def unflatten(like, flat):
    """A tree with the structure of `like` whose leaves are `flat` (JAX
    order)."""
    it = iter(flat)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
