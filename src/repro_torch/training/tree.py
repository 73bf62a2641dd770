"""Param and state trees: nested dicts of tensors, walked in sorted-key
order, the order in which ``jax.tree_util`` flattens a dict."""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` on each leaf of ``tree`` and the subtrees of ``rest`` at the
    same place (``rest`` may hold a dict where ``tree`` holds a leaf: an
    8-bit moment's ``{"q", "scale"}``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tree_paths(tree, prefix: str = "") -> dict:
    """``{"/"-joined key path: leaf}``, the reference checkpoint's keys, in
    the order :func:`tree_map` visits the leaves."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(tree_paths(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}
