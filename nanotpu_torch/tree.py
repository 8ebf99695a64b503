"""Parameter trees: nested dicts and lists (or tuples, named ones such as
``QArray`` included) of tensors, nanotpu's pytree layout, walked in one
fixed order (dict keys as inserted, list items in order)."""

from __future__ import annotations


def leaves(tree) -> list:
    """The leaves of ``tree`` in order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in leaves(v)]
    return [tree]


def map_tree(fn, tree, *rest):
    """``tree`` with each leaf replaced by ``fn(leaf, *matching leaves of
    rest)``; the trees in ``rest`` have the same structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return rebuild(tree, [map_tree(fn, v, *(r[i] for r in rest))
                              for i, v in enumerate(tree)])
    return fn(tree, *rest)


def rebuild(seq, items):
    """A list or tuple of ``seq``'s type holding ``items``: a named tuple
    takes its fields as arguments, the others take one iterable."""
    if hasattr(seq, "_fields"):
        return type(seq)(*items)
    return type(seq)(items)
