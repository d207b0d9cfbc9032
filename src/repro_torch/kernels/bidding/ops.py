"""The bidding stage of the assignment solver's rounds on K4.

Counterpart of ``repro/kernels/bidding/ops.py``. ``bidding_op`` is what
``core/assignment/cost_scaling.py`` calls under ``backend="pallas"``: K4
on the card, its plain version on the CPU, with any leading batch axes
(the reference ``vmap``s the op once per axis). The masks the two rounds
build (``fixed`` for the auction, ``fixed | (F == 1)`` for push-relabel)
stay plain tensor code; folding them into K4 is later work (ROADMAP).
"""
from __future__ import annotations

from repro_torch.kernels.bidding.kernel import bidding


def bidding_op(c, p_y, mask):
    """``(min1, arg1, min2)`` per row of ``where(mask, INF, c - p_y)``
    (see ``kernel.bidding``); inputs are made contiguous first."""
    return bidding(c.contiguous(), p_y.contiguous(), mask.contiguous())
