"""Nested containers of tensors, in the reference's (JAX's) tree order.

The port's parameters and optimizer states are nested dicts of tensors,
with `NamedTuple`s (`optim.AdamWState`) around them, as the reference's
pytrees are. A dict's keys are walked in sorted order and a tuple's
items (a `NamedTuple`'s fields) in their own order, as
`jax.tree_util` walks them; that order fixes the global gradient norm's
sum and a checkpoint's keys. ``None`` is an empty subtree.

A leaf stored by its `Spec` over a mesh (`launch.mesh.Sharded`) is a
list of its shards' blocks: the walks below treat it as structure (a
block a leaf) and keep its storage plan; `map_sharded` and
`flatten_global` treat it as one leaf, and `distinct_leaves` counts
each of its blocks once.
"""
from __future__ import annotations

from ..launch.mesh import Sharded


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_paths(tree, prefix: str = "") -> dict:
    """{path: leaf} in tree order. A path joins the keys with "/": a dict
    key as it is, a sequence index as a number, a `NamedTuple` field as
    ``.name`` (the reference checkpoint's own spelling)."""
    out = {}
    _walk(tree, prefix, out)
    return out


def flatten_global(tree) -> dict:
    """`flatten_with_paths` with a `Sharded` leaf as one leaf under its
    own path: the paths of the global tree it stores (a checkpoint's
    keys)."""
    out = {}
    _walk(tree, "", out, whole=True)
    return out


def _walk(node, path: str, out: dict, whole: bool = False) -> None:
    # a module-level function, not a closure over ``out``: a recursive
    # closure is a reference cycle, and its leaves (a step's gradients)
    # would live on until the garbage collector ran
    if node is None:
        return
    if whole and isinstance(node, Sharded):
        out[path] = node
        return
    if isinstance(node, dict):
        items = ((str(k), node[k]) for k in sorted(node))
    elif _is_namedtuple(node):
        items = ((f".{f}", getattr(node, f)) for f in node._fields)
    elif isinstance(node, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(node))
    else:
        out[path] = node
        return
    for key, child in items:
        _walk(child, f"{path}/{key}" if path else key, out, whole)


def tree_leaves(tree) -> list:
    return list(flatten_with_paths(tree).values())


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which share its structure); the result has its structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, Sharded):
        return tree.like([tree_map(fn, *xs) for xs in zip(tree, *rest)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def unflatten_like(like, values: dict):
    """``like``'s structure with each leaf replaced by ``values[path]``
    (paths as `flatten_with_paths` spells them)."""
    paths = iter(flatten_with_paths(like))
    return tree_map(lambda _: values[next(paths)], like)


def map_sharded(fn, tree):
    """``fn`` over the leaves of ``tree``, a `Sharded` leaf passed whole."""
    if tree is None:
        return None
    if isinstance(tree, Sharded):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_sharded(fn, tree[k]) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(map_sharded(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_sharded(fn, x) for x in tree)
    return fn(tree)


def distinct_leaves(tree) -> list:
    """The leaves in tree order, a `Sharded` leaf giving one block per
    distinct region (`Sharded.owners`): each element of the global tree
    once."""
    out: list = []
    map_sharded(lambda x: out.extend([x[k] for k in x.owners()]
                                     if isinstance(x, Sharded) else [x]),
                tree)
    return out
