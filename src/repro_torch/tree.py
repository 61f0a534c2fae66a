"""Parameter trees: nested dicts, tuples and NamedTuples of tensors.

The JAX package walks its trees with ``jax.tree``; the port's trees have
the same nesting, and ``leaves_with_path`` visits them in JAX's order --
dict keys sorted, tuple items in order, NamedTuple fields in order -- with
JAX's path names (``0/blocks/ffn/wd``, ``1/.m/embed``), so a checkpoint's
leaf ``i`` is the same leaf in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def leaves_with_path(tree: Any, path: Tuple[str, ...] = ()
                     ) -> Iterator[Tuple[str, Any]]:
    """(JAX-style path name, leaf) in JAX's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for f, v in zip(tree._fields, tree):
            yield from leaves_with_path(v, path + ("." + f,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(like: Any, new_leaves: List[Any]) -> Any:
    """A tree shaped like ``like`` holding ``new_leaves`` in ``leaves``
    order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            got = {k: build(t[k]) for k in sorted(t)}
            return {k: got[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
