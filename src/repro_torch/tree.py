"""Trees of tensors: nested dicts (keys in sorted order), lists and tuples,
``None`` an empty subtree, in the order and with the path names
``jax.tree_util`` gives the JAX package's trees (``checkpoint.store`` writes
leaves under these names)."""
from __future__ import annotations

from collections.abc import Callable, Iterator
from typing import Any

_SEP = "/"


def flatten_with_paths(tree) -> list[tuple[str, Any]]:
    """(name, leaf) pairs: keys and list indices joined by ``/``."""
    out: list[tuple[str, Any]] = []

    def walk(t, keys):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], keys + [str(k)])
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, keys + [str(i)])
        elif t is not None:
            out.append((_SEP.join(keys), t))

    walk(tree, [])
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(target, new_leaves) -> Any:
    """``target``'s structure (tuples become lists) with its leaves replaced
    by ``new_leaves`` in flatten order."""
    it: Iterator = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return None if t is None else next(it)

    return build(target)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``,
    which share its structure."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *others)])
