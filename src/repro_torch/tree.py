"""Nested dicts of tensors: the port's pytrees (dict keys in the order
``jax.tree_util`` gives them, sorted at every level)."""
from __future__ import annotations

from typing import Any, Callable, Dict


def flatten(tree, prefix="") -> Dict[str, Any]:
    """Nested dicts of tensors -> {key path: leaf}, keys joined by "/"."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def tree_map(fn: Callable, tree):
    """The same nesting with ``fn`` applied to every leaf."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def unflatten(flat: Dict[str, Any]):
    """The inverse of ``flatten``: {key path: leaf} -> nested dicts."""
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        *path, last = key.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return out
