"""Param-tree helpers with the JAX package's leaf order and leaf names.

A tree is nested dicts, lists and tuples of tensors (the port keeps the
JAX pytree layout). `flatten_with_path` walks it as
`jax.tree_util.tree_flatten_with_path` does, dict keys sorted, and names
each leaf by `jax.tree_util.keystr` of its path, e.g.
"['groups'][0][0]['attn']['wq']". The optimizer walks leaves in this
order and checkpoints key them by these names, so both sides agree.
"""
from __future__ import annotations


def flatten_with_path(tree, prefix: str = "") -> list:
    """-> [(keystr, leaf)] in the reference's leaf order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten_with_path(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten_with_path(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [v for _, v in flatten_with_path(tree)]


def unflatten(tree, new_leaves):
    """`tree`'s structure with its leaves replaced, in `leaves` order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *ys) for x, *ys in
                            zip(leaves(tree), *others)])
