"""Plain PyTorch version of K4 ``bidding`` (per-row top-2 bid).

Counterpart of ``repro/kernels/bidding/ref.py``. The CPU path of the
wrapper in ``kernel.py`` runs it, and ``chip_smoke.py`` holds the CUDA
kernel to it bit for bit on the card. Leading batch axes are native, where
the reference ``vmap``s once per axis.
"""
from __future__ import annotations

import torch

INF = 2 ** 30   # int32 cost "infinity" of the assignment solver


def bidding_ref(c, p_y, mask):
    """Per row, ``(min1, arg1, min2)`` of ``where(mask, INF, c - p_y)``.

    ``c`` ``(..., n_r, n_c)`` int32, ``p_y`` ``(..., n_c)`` int32, ``mask``
    ``(..., n_r, n_c)`` bool (True = not residual). ``arg1`` is the FIRST
    column attaining ``min1``; ``min2`` is the minimum over every other
    column and INF, so a tie gives ``min2 == min1``. A row with every
    entry masked gives ``(INF, 0, INF)``. All three are ``(..., n_r)``
    int32.
    """
    adj = torch.where(mask, INF, c - p_y.unsqueeze(-2))
    min1 = torch.amin(adj, dim=-1)
    arg1 = torch.argmin(adj, dim=-1)
    cols = torch.arange(adj.shape[-1], device=adj.device)
    adj2 = torch.where(cols == arg1.unsqueeze(-1), INF, adj)
    return min1, arg1.to(torch.int32), torch.amin(adj2, dim=-1)
