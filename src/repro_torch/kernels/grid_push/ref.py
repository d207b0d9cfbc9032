"""Plain PyTorch versions of K1 ``grid_push_decide`` and K2
``grid_push_decide_sched`` (the per-node push/relabel decision).

Counterpart of ``repro/kernels/grid_push/ref.py``. The CPU path of the
wrappers in ``kernel.py`` runs these, and ``chip_smoke.py`` holds the CUDA
kernels to them bit for bit on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.maxflow.grid import INF_H, _nbr_h


def grid_push_decide_ref(e, h, cap, cap_src, cap_sink, n_nodes):
    """Per-node push/relabel decision of one Jacobi round.

    ``e``/``h``/``cap_src``/``cap_sink`` are ``(..., H, W)``, ``cap``
    ``(4, ..., H, W)``. Returns ``(h_new, delta)`` with ``delta``
    ``(6, ..., H, W)``: the flow pushed toward [sink, source, UP, DOWN,
    LEFT, RIGHT]. The choice is the FIRST minimum of the candidate heights
    in that order (strict ``<``), as the reference's ``argmin``.
    """
    inf = torch.full_like(h, INF_H)
    cand = [torch.where(cap_sink > 0, torch.zeros_like(h), inf),
            torch.where(cap_src > 0, torch.full_like(h, n_nodes), inf)]
    cand += [torch.where(cap[d] > 0, _nbr_h(h, d), inf) for d in range(4)]
    caps = [cap_sink, cap_src] + [cap[d] for d in range(4)]

    h_min, choice, chosen_cap = cand[0], torch.zeros_like(h), caps[0]
    for k in range(1, 6):
        better = cand[k] < h_min
        h_min = torch.where(better, cand[k], h_min)
        choice = torch.where(better, k, choice)
        chosen_cap = torch.where(better, caps[k], chosen_cap)

    active = e > 0
    do_push = active & (h > h_min)
    do_relabel = active & (h <= h_min) & (h_min < INF_H)
    h_new = torch.where(do_relabel, h_min + 1, h)
    moved = torch.where(do_push, torch.minimum(e, chosen_cap),
                        torch.zeros_like(e))
    delta = torch.stack([torch.where(choice == p, moved, torch.zeros_like(e))
                         for p in range(6)])
    return h_new, delta


def tile_mask(sched, n_active, H: int, W: int, bh: int, bw: int):
    """``(B, H, W)`` bool: nodes of the tiles K2 decides on.

    Tile ``sched[b, i]`` is decided where ``i < n_active[b]`` and copied
    through (identity) elsewhere.
    """
    B, T = sched.shape
    pos = torch.arange(T, device=sched.device).expand(B, T)
    decide = torch.zeros((B, T), dtype=torch.bool, device=sched.device)
    decide.scatter_(1, sched.long(), pos < n_active[:, None])
    tiles = decide.reshape(B, H // bh, 1, W // bw, 1)
    return tiles.expand(B, H // bh, bh, W // bw, bw).reshape(B, H, W)


def grid_push_decide_sched_ref(e, h, cap, cap_src, cap_sink, sched,
                               n_active, n_nodes, bh: int, bw: int):
    """K2: the K1 decision on scheduled active tiles, identity elsewhere.

    ``e``/``h``/``cap_src``/``cap_sink`` ``(B, H, W)``, ``cap``
    ``(4, B, H, W)``, ``sched`` ``(B, T)`` a per-instance permutation of
    the row-major tile ids, ``n_active`` ``(B,)``.
    """
    H, W = e.shape[-2:]
    h_new, delta = grid_push_decide_ref(e, h, cap, cap_src, cap_sink,
                                        n_nodes)
    m = tile_mask(sched, n_active, H, W, bh, bw)
    return (torch.where(m, h_new, h),
            torch.where(m, delta, torch.zeros_like(delta)))
