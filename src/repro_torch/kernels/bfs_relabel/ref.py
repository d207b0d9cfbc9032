"""Plain PyTorch version of K3 ``bfs_relabel_sweeps``.

Counterpart of ``repro/kernels/bfs_relabel/ref.py``. The CPU path of the
wrapper in ``kernel.py`` runs it, and ``chip_smoke.py`` holds the CUDA
kernel to it bit for bit on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.maxflow.grid import INF_H, _nbr_h


def _relax(plane, cap, seed):
    """One min-plus sweep of a wavefront plane (batch axes pass through)."""
    out = plane
    for d in range(4):
        out = torch.minimum(out, torch.where(cap[d] > 0, _nbr_h(plane, d) + 1,
                                             INF_H))
    return torch.minimum(out, seed)


def bfs_relabel_sweeps_ref(cap, seed_t, seed_s, dt, ds, *, sweeps: int):
    """``sweeps`` joint relaxation sweeps of ``dt`` and (unless ``ds`` is
    None) ``ds``; returns ``(dt, ds, changed)`` with ``changed`` a 0-dim
    int32, 1 iff any value moved. Sweeps never raise a value, so that is
    the same as the result differing from the input.
    """
    dt0, ds0 = dt, ds
    for _ in range(sweeps):
        dt = _relax(dt, cap, seed_t)
        if ds is not None:
            ds = _relax(ds, cap, seed_s)
    changed = (dt != dt0).any()
    if ds is not None:
        changed = changed | (ds != ds0).any()
    return dt, ds, changed.to(torch.int32)
