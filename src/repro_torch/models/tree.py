"""Nested dicts of tensors: the port's stand-in for ``jax.tree``.

The reference keeps params, optimizer state and caches as dict pytrees,
and ``jax.tree`` walks a dict in sorted key order. These helpers walk
the port's trees in that same order, so a flat list of leaves lines up
with the reference's ``jax.tree.leaves`` and a ``/``-joined path names
the same leaf in both packages (``blocks/attn/wq/w``).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

__all__ = ["tree_map", "tree_leaves", "tree_items", "tree_from_items",
           "tree_unflatten", "stack_layers", "unbind_layers"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` on every leaf of ``tree`` (and the same leaf of each of
    ``rest``, which must have the same keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like: Any, leaves: Iterable) -> Any:
    """``leaves`` (in ``tree_leaves`` order) put into the shape of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_items(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs in leaf order; paths joined by ``/``."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += tree_items(tree[k], f"{prefix}/{k}" if prefix else k)
    return out


def tree_from_items(items: Iterable[tuple[str, Any]]) -> dict:
    """The nested dict whose ``tree_items`` are ``items``."""
    out: dict = {}
    for path, leaf in items:
        *parents, last = path.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def stack_layers(make: Callable[[], Any], n: int,
                 keep: Callable[[str, Any], Any] | None = None) -> Any:
    """``n`` calls of ``make()`` (a tree of tensors each) stacked on a new
    leading axis, the reference's ``vmap``-ed block init. One layer is
    built at a time and copied into its row, so the peak holds the stack
    and one layer, not every layer twice. ``keep(path, tensor)``, when
    given, cuts each layer's leaf (a rank's shard) before it is stored."""
    def cut(layer):
        if keep is None:
            return layer
        return tree_from_items((p, keep(p, t)) for p, t in tree_items(layer))

    first = cut(make())
    out = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    for i in range(n):
        layer = first if i == 0 else cut(make())
        tree_map(lambda o, t, i=i: o[i].copy_(t), out, layer)
        del layer
    return out


def unbind_layers(stacked: Any, n: int) -> list:
    """A stacked tree as one tree of views a layer (``n`` of them)."""
    per = tree_map(lambda t: t.unbind(0), stacked)
    return [tree_map(lambda parts, i=i: parts[i], per) for i in range(n)]
