"""Trees of tensors: the port's stand-in for the ``jax.tree_util`` calls of
the JAX package's model, optimizer and training code.

A tree is a nest of dicts, lists, tuples and NamedTuples whose leaves are
tensors (or anything else that is not a container; ``None`` is an empty
node, as in JAX). Leaves are visited in JAX's order: dict keys sorted,
sequence and NamedTuple entries in order. A leaf's path string is
``repro.ckpt.save._flatten``'s key letter for letter: dict keys as they
are, sequence indices as numbers, NamedTuple fields as ``.name``
(``groups/l0/attn/.wq``), so checkpoints, Muon task names and the
optimizer's exclusions read the same in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> List[Tuple[str, Any]]:
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [("." + f, getattr(node, f)) for f in node._fields]
    return [(str(i), v) for i, v in enumerate(node)]


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def flatten_with_path(tree) -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in JAX's leaf order."""
    out: List[Tuple[str, Any]] = []

    def visit(prefix: str, node) -> None:
        if node is None:
            return
        if not _is_node(node):
            out.append((prefix, node))
            return
        for key, child in _children(node):
            visit(f"{prefix}/{key}" if prefix else key, child)

    visit("", tree)
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def map_with_path(fn: Callable, tree, *rest):
    """``fn(path, leaf, *matching leaves of rest)`` over ``tree``, keeping
    its structure (the counterpart of ``tree_map_with_path``)."""

    def go(prefix: str, node, others):
        if node is None:
            return None
        if not _is_node(node):
            return fn(prefix, node, *others)
        if isinstance(node, dict):
            return {k: go(f"{prefix}/{k}" if prefix else str(k), node[k],
                          [o[k] for o in others]) for k in node}
        if _is_namedtuple(node):
            return type(node)(*(
                go(f"{prefix}/.{f}" if prefix else "." + f, getattr(node, f),
                   [getattr(o, f) for o in others]) for f in node._fields))
        return type(node)(
            go(f"{prefix}/{i}" if prefix else str(i), v, [o[i] for o in others])
            for i, v in enumerate(node))

    return go("", tree, list(rest))


def map(fn: Callable, tree, *rest):  # noqa: A001 - mirrors tree_util.tree_map
    """``fn(leaf, *matching leaves of rest)`` over ``tree``."""
    return map_with_path(lambda _, *xs: fn(*xs), tree, *rest)


def unflatten_like(like, by_path: Dict[str, Any]):
    """A tree of ``like``'s structure whose leaves are ``by_path[path]``."""
    return map_with_path(lambda path, _: by_path[path], like)
