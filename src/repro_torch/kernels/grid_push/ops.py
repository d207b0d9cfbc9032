"""Full Jacobi rounds around the K1 / K2 decision kernels.

Counterpart of ``repro/kernels/grid_push/ops.py``. ``jacobi_round_pallas``
is the decision on K1 followed by the shift-add deposit;
``jacobi_round_scheduled`` builds a per-instance ACTIVE-TILE SCHEDULE
(tiles holding a node with excess, first) and runs the decision on K2
over it. A tile with no active node is an exact no-op under one round, so
both transitions equal ``repro_torch.core.maxflow.grid.jacobi_round`` bit
for bit. ``jacobi_round_scheduled`` also returns the per-instance RETIRED
flow (excess delivered to the sink or returned to the source this round),
the balanced backend's stall signal.

The deposit stays plain tensor code, as the reference leaves it to XLA;
fusing it into a gather kernel is later work (ROADMAP).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.maxflow.grid import (GridFlowState, _OPP, _gsum,
                                           _move)
from repro_torch.kernels.grid_push.kernel import (grid_push_decide,
                                                  grid_push_decide_sched)

BLOCK = 64   # K2 tile edge


def _deposit(state: GridFlowState, h_new, delta) -> GridFlowState:
    """Shift-add flow deposit shared by every round.

    ``delta`` is ``(6, ..., H, W)`` over [sink, source, UP, DOWN, LEFT,
    RIGHT]. Operation order as the reference: ``out = 0 + d_sink + d_src
    + Σ d_nbr``, then ``e - out + inflow``.
    """
    d_sink, d_src = delta[0], delta[1]
    d_nbr = [delta[2 + d] for d in range(4)]
    out = d_sink + d_src + sum(d_nbr)
    inflow = sum(_move(d_nbr[d], d) for d in range(4))
    cap_new = torch.stack(
        [state.cap[d] - d_nbr[d] + _move(d_nbr[_OPP[d]], _OPP[d])
         for d in range(4)], 0)
    return state._replace(
        e=state.e - out + inflow, h=h_new, cap=cap_new,
        cap_src=state.cap_src - d_src, cap_sink=state.cap_sink - d_sink,
        sink_flow=state.sink_flow + _gsum(d_sink),
        src_flow=state.src_flow + _gsum(d_src),
    )


def jacobi_round_pallas(state: GridFlowState, n_nodes: int) -> GridFlowState:
    """One Jacobi round with the decision on K1 (``backend="pallas"``)."""
    h_new, delta = grid_push_decide(state.e, state.h, state.cap,
                                    state.cap_src, state.cap_sink, n_nodes)
    return _deposit(state, h_new, delta)


def tile_shape(H: int, W: int) -> tuple[int, int]:
    """K2's tile: ``BLOCK`` along an axis it divides, else the whole axis
    (the reference's rule, so schedules compare equal)."""
    bh, bw = min(BLOCK, H), min(BLOCK, W)
    return (H if H % bh else bh), (W if W % bw else bw)


def tile_schedule(active: torch.Tensor, block_h: int, block_w: int):
    """Compacted tile schedule from a per-node activity mask.

    Args:
      active: ``(B, H, W)`` bool, which nodes hold excess this round.
      block_h / block_w: the tile shape (must divide H, W).

    Returns ``(sched, n_active)``: ``sched`` ``(B, T)`` int32, per
    instance a permutation of the row-major tile ids with every tile
    holding an active node moved to the front, in tile-id order (a stable
    sort, so the schedule is a pure function of the mask); ``n_active``
    ``(B,)`` int32.
    """
    B, H, W = active.shape
    nth, ntw = H // block_h, W // block_w
    tile_act = active.reshape(B, nth, block_h, ntw, block_w).any(4).any(2)
    tile_act = tile_act.reshape(B, nth * ntw)
    # A stable sort of an int32 key (0 = active, 1 = idle), not of the bool
    # mask: the reference argsorts the negated mask, which orders the same.
    key = (~tile_act).to(torch.int32)
    sched = torch.sort(key, dim=1, stable=True).indices.to(torch.int32)
    return sched, tile_act.sum(1).to(torch.int32)


def jacobi_round_scheduled(state: GridFlowState, n_nodes: int):
    """One Jacobi round dispatched over active tiles only (K2).

    Returns ``(new_state, retired)`` where ``retired`` is the per-instance
    flow delivered to the sink or returned to the source this round.
    Shape-polymorphic over leading batch axes.
    """
    *batch, H, W = state.e.shape
    bh, bw = tile_shape(H, W)
    B = int(np.prod(batch, dtype=np.int64))
    e = state.e.reshape(B, H, W)
    sched, n_active = tile_schedule(e > 0, bh, bw)
    h_new, delta = grid_push_decide_sched(
        e, state.h.reshape(B, H, W), state.cap.reshape(4, B, H, W),
        state.cap_src.reshape(B, H, W), state.cap_sink.reshape(B, H, W),
        sched, n_active, n_nodes, block_h=bh, block_w=bw)
    h_new = h_new.reshape(state.h.shape)
    delta = delta.reshape((6,) + tuple(state.e.shape))
    retired = _gsum(delta[0] + delta[1])
    return _deposit(state, h_new, delta), retired
