"""Plain PyTorch version of K5 ``frontier`` (one BFS expansion sweep).

Counterpart of ``repro/kernels/frontier/ref.py``. The CPU path of the
wrapper in ``kernel.py`` runs it, and ``chip_smoke.py`` holds the CUDA
kernel to it bit for bit on the card. Leading batch axes are native, where
the reference ``vmap``s once per axis.
"""
from __future__ import annotations

import torch

INF = 2 ** 30   # int32 "unlabeled" of the matching solver


def frontier_ref(adj, root_row, match_row):
    """Per column, the keyed minimum (root, then row) over candidate rows.

    ``adj`` ``(..., n_r, n_c)`` bool; ``root_row`` / ``match_row``
    ``(..., n_r)`` int32 (root INF = unlabeled, match -1 = free). Row ``i``
    is a candidate of column ``j`` iff ``adj[i, j] & (root_row[i] < INF)
    & (match_row[i] != j)``. Returns ``(min_root, claim_row)``, both
    ``(..., n_c)`` int32: the smallest candidate root and the smallest row
    holding it, ``(INF, 0)`` where a column has no candidate.
    """
    n_r, n_c = adj.shape[-2:]
    cols = torch.arange(n_c, dtype=torch.int32, device=adj.device)
    rows = torch.arange(n_r, dtype=torch.int32, device=adj.device)
    root = root_row.unsqueeze(-1)
    cand = torch.where(adj & (root < INF) & (match_row.unsqueeze(-1) != cols),
                       root, INF)
    min_root = torch.amin(cand, dim=-2)
    claim = torch.amin(torch.where(cand == min_root.unsqueeze(-2),
                                   rows.unsqueeze(-1), INF), dim=-2)
    return min_root, claim
