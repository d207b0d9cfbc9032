"""Per-instance liveness freeze: the one primitive behind batched solving.

Counterpart of ``repro/core/masking.py``. Each outer iteration computes a
candidate next state for the whole batch, then ``freeze`` selects the old
state back in for instances whose mask is False, so a converged instance
is an exact no-op.

Solver states are tensors or (named) tuples of them, nested, with ``None``
leaves (``GridFlowState.heur`` of a hand-built state). ``tree_map`` and
``tree_leaves`` walk them as ``jax.tree`` does: ``None`` is skipped.
"""
from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """``fn(leaf, *other_leaves)`` over matching (named) tuples, nested;
    ``None`` leaves of ``tree`` stay ``None`` and ``fn`` never sees them."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        fields = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*fields) if hasattr(tree, "_fields") \
            else tuple(fields)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Every non-``None`` leaf of ``tree``, depth first."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


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
