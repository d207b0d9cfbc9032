"""Per-instance liveness freeze: the one primitive behind batched solving.

Counterpart of ``repro/core/masking.py``. Each outer iteration computes a
candidate next state for the whole batch, then ``freeze`` selects the old
state back in for instances whose mask is False, so a converged instance
is an exact no-op.
"""
from __future__ import annotations

import torch


def freeze(live, new, old, lead_axes_fn=None):
    """Select ``new`` where ``live`` else ``old``, per leaf.

    ``new`` and ``old`` are tensors or (named) tuples of tensors, with
    ``None`` leaves passed through. ``live`` has the batch shape (``()``
    for a single instance, ``(B,)`` for a batch); leaves carry the batch
    axes plus trailing data axes. ``lead_axes_fn(leaf) -> int`` names how
    many leaf axes PRECEDE the batch axes (e.g. the direction axis of the
    grid solver's ``cap``); default 0.
    """
    if new is None:
        return None
    if isinstance(new, tuple):
        fields = [freeze(live, a, b, lead_axes_fn) for a, b in zip(new, old)]
        return type(new)(*fields) if hasattr(new, "_fields") else tuple(fields)
    lead = lead_axes_fn(new) if lead_axes_fn else 0
    m = live.reshape((1,) * lead + tuple(live.shape)
                     + (1,) * (new.dim() - live.dim() - lead))
    return torch.where(m, new, old)
