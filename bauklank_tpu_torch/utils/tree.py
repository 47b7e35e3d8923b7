"""Engine states as trees: tensors (or numpy arrays) in tuples and named
tuples, the layout of the JAX package's state pytrees.

:func:`keyed_leaves` names each leaf by its path as
``jax.tree_util.keystr`` does (``.field`` for a named tuple's field,
``[i]`` for a tuple's item), so a checkpoint written by either package
has the same npz keys.
"""

from __future__ import annotations

__all__ = ["tree_map", "keyed_leaves", "tree_from_keyed"]


def _is_node(x) -> bool:
    return isinstance(x, (tuple, list))


def _build(node, parts):
    return type(node)(*parts) if hasattr(node, "_fields") else type(node)(parts)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, in a tree of the same structure."""
    if not _is_node(tree):
        return fn(tree, *rest)
    return _build(tree, [tree_map(fn, *xs) for xs in zip(tree, *rest)])


def _key(node, i: int) -> str:
    return f".{node._fields[i]}" if hasattr(node, "_fields") else f"[{i}]"


def keyed_leaves(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(``jax.tree_util.keystr`` of the leaf's path, leaf) in flattening
    order."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for i, x in enumerate(tree):
        out.extend(keyed_leaves(x, prefix + _key(tree, i)))
    return out


def tree_from_keyed(template, lookup, prefix: str = ""):
    """A tree of ``template``'s structure whose leaf at each path is
    ``lookup(keystr, template_leaf)``."""
    if not _is_node(template):
        return lookup(prefix, template)
    return _build(template, [tree_from_keyed(x, lookup, prefix + _key(template, i))
                             for i, x in enumerate(template)])
