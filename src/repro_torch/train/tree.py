"""Pytrees of tensors in ``jax.tree.flatten``'s leaf order.

A dict's items are visited in the order of their keys read as dotted paths
(``"mlp.fc0.w"`` -> ``("mlp", "fc0", "w")``, an index part such as the
``10`` of ``blocks.10`` by number), so the flat dict of a module's
``named_parameters`` flattens as JAX flattens the nested params tree it
mirrors; for keys without dots this is JAX's sorted-key order.
Tuples, lists and NamedTuples are visited in order, ``None`` holds no leaf,
and everything else is a leaf.  ``torch.utils._pytree`` visits dicts in
insertion order, which is why the port keeps this one.
"""

from __future__ import annotations

from typing import Any, Callable


def _key(k) -> tuple:
    # an index part (a list's item, ``blocks.10``) sorts by number, as JAX
    # visits a list
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p) for p in str(k).split("."))


def _children(node) -> list | None:
    if isinstance(node, dict):
        return [node[k] for k in sorted(node, key=_key)]
    if isinstance(node, (tuple, list)):
        return list(node)
    return None


def leaves(tree) -> list:
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in leaves(kid)]


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure holding ``new_leaves`` (in ``leaves`` order)."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node, key=_key)}
            return {k: built[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(x) for x in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    flat = [leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError(f"trees differ in leaf count: {[len(f) for f in flat]}")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])


def describe(tree) -> str:
    """The structure with ``*`` for each leaf, for a checkpoint's manifest."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k])}"
                               for k in sorted(tree, key=_key)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={describe(x)}" for f, x in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (tuple, list)):
        o, c = ("(", ")") if isinstance(tree, tuple) else ("[", "]")
        return o + ", ".join(describe(x) for x in tree) + c
    return "*"
