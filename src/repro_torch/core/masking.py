"""Per-instance liveness freeze: the one primitive behind batched solving.

Counterpart of ``repro/core/masking.py``. Each outer iteration computes a
candidate next state for the whole batch, then ``freeze`` selects the old
state back in for instances whose mask is False, so a converged instance
is an exact no-op.

Solver states are tensors or (named) tuples of them, nested, with ``None``
leaves (``GridFlowState.heur`` of a hand-built state); the warm-start
layer also walks dicts (cached solutions) and lists. ``tree_map``,
``tree_leaves``, ``tree_flatten`` and ``tree_unflatten`` walk them as
``jax.tree`` does: ``None`` is skipped, a named tuple goes field by field
and a dict goes in SORTED key order (not insertion order, as
``torch.utils._pytree`` would), so content hashes, delta bounds and the
checkpoint store's leaf order agree with the JAX package's.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


def tree_map(fn, tree, *rest):
    """``fn(leaf, *other_leaves)`` over matching (named) tuples, lists and
    dicts, nested; ``None`` leaves of ``tree`` stay ``None`` and ``fn``
    never sees them."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        fields = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*fields) if hasattr(tree, "_fields") \
            else tuple(fields)
    if isinstance(tree, list):
        return [tree_map(fn, *xs) for xs in zip(tree, *rest)]
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


class TreeDef(NamedTuple):
    """The structure ``tree_flatten`` strips off: ``node`` is ``"leaf"``,
    ``"none"``, ``"tuple"``, ``"list"``, ``"dict"`` or a named tuple's
    class; ``keys`` are a dict's sorted keys; ``children`` the subtrees'
    definitions."""

    node: Any
    keys: tuple = ()
    children: tuple = ()


def tree_flatten(tree) -> tuple[list, TreeDef]:
    """``(leaves, treedef)`` in ``jax.tree.flatten``'s order."""
    if tree is None:
        return [], TreeDef("none")
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        subs = [tree_flatten(tree[k]) for k in keys]
        node = "dict"
    elif isinstance(tree, tuple):
        keys = ()
        subs = [tree_flatten(x) for x in tree]
        node = type(tree) if hasattr(tree, "_fields") else "tuple"
    elif isinstance(tree, list):
        keys, subs, node = (), [tree_flatten(x) for x in tree], "list"
    else:
        return [tree], TreeDef("leaf")
    leaves = [leaf for sub, _ in subs for leaf in sub]
    return leaves, TreeDef(node, keys, tuple(d for _, d in subs))


def _n_leaves(treedef: TreeDef) -> int:
    if treedef.node == "leaf":
        return 1
    return sum(_n_leaves(c) for c in treedef.children)


def tree_unflatten(treedef: TreeDef, leaves):
    """Inverse of ``tree_flatten``: ``leaves`` back into ``treedef``."""
    leaves = list(leaves)
    if len(leaves) != _n_leaves(treedef):
        raise ValueError(f"tree_unflatten: {len(leaves)} leaves for a "
                         f"structure of {_n_leaves(treedef)}")
    it = iter(leaves)

    def build(d: TreeDef):
        if d.node == "leaf":
            return next(it)
        if d.node == "none":
            return None
        subs = [build(c) for c in d.children]
        if d.node == "dict":
            return dict(zip(d.keys, subs))
        if d.node == "list":
            return subs
        if d.node == "tuple":
            return tuple(subs)
        return d.node(*subs)

    return build(treedef)


def tree_leaves(tree) -> list:
    """Every non-``None`` leaf of ``tree``, in ``jax.tree.leaves``'s
    order."""
    return tree_flatten(tree)[0]


def freeze(live, new, old, lead_axes_fn=None):
    """Select ``new`` where ``live`` else ``old``, per leaf.

    ``new`` and ``old`` are tensors or (named) tuples of tensors, with
    ``None`` leaves passed through. ``live`` has the batch shape (``()``
    for a single instance, ``(B,)`` for a batch); leaves carry the batch
    axes plus trailing data axes. ``lead_axes_fn(leaf) -> int`` names how
    many leaf axes PRECEDE the batch axes (e.g. the direction axis of the
    grid solver's ``cap``); default 0.
    """
    def select(n, o):
        lead = lead_axes_fn(n) if lead_axes_fn else 0
        m = live.reshape((1,) * lead + tuple(live.shape)
                         + (1,) * (n.dim() - live.dim() - lead))
        return torch.where(m, n, o)

    return tree_map(select, new, old)
