"""Fixpoint driver for K3: the balanced backend's global/gap relabel.

Counterpart of ``repro/kernels/bfs_relabel/ops.py``. ``bfs_relabel_heights``
runs K3 ``SWEEPS`` sweeps at a time, with one host sync per call on the
kernel's ``changed`` flag, until nothing moves or ``max_iters`` is reached
(``it`` grows by ``SWEEPS`` per call, as in the reference). The labeling is
BIDIRECTIONAL: nodes unreached from the sink get the return gradient
``N + dist_to_source`` instead of the flat gap value ``N``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.maxflow.grid import INF_H
from repro_torch.kernels.bfs_relabel.kernel import SWEEPS, bfs_relabel_sweeps


def bfs_relabel_heights(cap, cap_src, cap_sink, h_prev, n_nodes: int,
                        max_iters: int):
    """Bidirectional global/gap relabel heights (balanced backend).

    Args:
      cap: ``(4, ..., H, W)`` residual neighbour capacities.
      cap_src / cap_sink: ``(..., H, W)`` residual terminal capacities.
      h_prev: ``(..., H, W)`` int32 current heights (never decreased).
      n_nodes: the paper's N = H*W + 2 (the source's conceptual height).
      max_iters: sweep budget.

    Returns ``(..., H, W)`` int32 heights: exact height-to-sink where the
    sink is residually reachable, else ``max(h_prev, N + dist_to_source)``
    where the source is, else ``max(h_prev, N)``.
    """
    *batch, H, W = h_prev.shape
    B = int(np.prod(batch, dtype=np.int64))
    cap4 = cap.reshape(4, B, H, W)
    seed_t = torch.where(cap_sink > 0, 1, INF_H).to(torch.int32).reshape(
        B, H, W)
    seed_s = torch.where(cap_src > 0, n_nodes + 1, INF_H).to(
        torch.int32).reshape(B, H, W)
    dt, ds, it, changed = seed_t, seed_s, 0, True
    while changed and it < max_iters:
        dt, ds, flag = bfs_relabel_sweeps(cap4, seed_t, seed_s, dt, ds)
        it += SWEEPS
        changed = bool(flag)
    dt = dt.reshape(h_prev.shape)
    ds = ds.reshape(h_prev.shape)
    return torch.where(dt < INF_H, dt,
                       torch.maximum(h_prev, torch.where(ds < INF_H, ds,
                                                         n_nodes)))
