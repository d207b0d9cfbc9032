"""Plain reference of batched push-relabel max-flow on 4-connected grids.

A frozen, self-contained copy of the algorithm the configuration names
(arXiv:1110.6231 §4: synchronous Jacobi push/relabel rounds, a global
relabel by backwards BFS from the sink every ``rounds_per_heuristic``
rounds, converged instances frozen by a liveness mask). It is written in
plain PyTorch and imports nothing of the program under test, so the
trajectory it follows (rounds, relabels, flow, cut) is the one the
configuration states, worked out independently.

Layout: ``cap`` is ``(4, B, H, W)``, the residual capacity of the edge
from node (i, j) toward its neighbour in direction UP, DOWN, LEFT, RIGHT;
every other plane is ``(B, H, W)``. On integer-valued capacities whose
flow stays below 2**24, float32 sums are exact in any order, so the
reference's numbers are exact; ``dtype`` lowers the precision of the
excess and capacities for the control.

``cut_capacity`` is a certificate that needs no trajectory at all: the
capacity of a cut, summed in float64 from the original capacities. A
flow value equal to the capacity of some cut is the maximum flow.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

UP, DOWN, LEFT, RIGHT = 0, 1, 2, 3
OPP = (DOWN, UP, RIGHT, LEFT)
INF_H = 2 ** 30
SWEEPS = 8          # BFS relaxation sweeps between two fixpoint tests


class GridAnswer(NamedTuple):
    flow: torch.Tensor        # (B,) flow delivered to the sink
    cut: torch.Tensor         # (B, H, W) bool, True = sink side
    rounds: torch.Tensor      # (B,) int32 rounds run while live
    heuristics: torch.Tensor  # (B,) int32 global relabels after the first
    converged: torch.Tensor   # (B,) bool, no excess left


def _nbr(plane, d: int, fill):
    """The value at each node's neighbour in direction ``d``; ``fill``
    outside the grid."""
    out = torch.full_like(plane, fill)
    if d == UP:
        out[..., 1:, :] = plane[..., :-1, :]
    elif d == DOWN:
        out[..., :-1, :] = plane[..., 1:, :]
    elif d == LEFT:
        out[..., :, 1:] = plane[..., :, :-1]
    else:
        out[..., :, :-1] = plane[..., :, 1:]
    return out


def _shift_to(a, d: int):
    """Move ``a[x]`` onto x's neighbour in direction ``d`` (zero fill)."""
    out = torch.zeros_like(a)
    if d == UP:
        out[..., :-1, :] = a[..., 1:, :]
    elif d == DOWN:
        out[..., 1:, :] = a[..., :-1, :]
    elif d == LEFT:
        out[..., :, :-1] = a[..., :, 1:]
    else:
        out[..., :, 1:] = a[..., :, :-1]
    return out


def bfs_heights(cap, cap_sink, h_prev, n_nodes: int):
    """Exact BFS distance to the sink in the residual graph; the nodes
    that cannot reach it keep ``max(h_prev, n_nodes)`` (gap relabel)."""
    seed = torch.where(cap_sink > 0, 1, INF_H).to(torch.int32)
    dist = seed
    while True:
        before = dist
        for _ in range(SWEEPS):
            best = dist
            for d in range(4):
                best = torch.minimum(best, torch.where(
                    cap[d] > 0, _nbr(dist, d, INF_H) + 1, INF_H))
            dist = torch.minimum(best, seed)
        if not bool((dist != before).any()):
            break
    return torch.where(dist >= INF_H, torch.clamp_min(h_prev, n_nodes),
                       dist)


def jacobi_round(e, h, cap, cs, ct, n_nodes: int):
    """One synchronous round: every node with excess pushes to its
    lowest residual target (sink, source, UP, DOWN, LEFT, RIGHT; the first
    one on a tie) if that lies lower, and relabels otherwise."""
    zero_h = torch.zeros_like(h)
    cand = [torch.where(ct > 0, zero_h, INF_H),
            torch.where(cs > 0, zero_h + n_nodes, INF_H)]
    cand += [torch.where(cap[d] > 0, _nbr(h, d, INF_H), INF_H)
             for d in range(4)]
    caps = [ct, cs] + [cap[d] for d in range(4)]
    h_min, choice, chosen = cand[0], zero_h, caps[0]
    for k in range(1, 6):
        lower = cand[k] < h_min
        h_min = torch.where(lower, cand[k], h_min)
        choice = torch.where(lower, k, choice)
        chosen = torch.where(lower, caps[k], chosen)
    active = e > 0
    push = active & (h > h_min)
    relabel = active & (h <= h_min) & (h_min < INF_H)
    h = torch.where(relabel, h_min + 1, h)
    moved = torch.where(push, torch.minimum(e, chosen), torch.zeros_like(e))
    d_sink = torch.where(choice == 0, moved, 0.0).to(e.dtype)
    d_src = torch.where(choice == 1, moved, 0.0).to(e.dtype)
    d_nbr = [torch.where(choice == 2 + d, moved, 0.0).to(e.dtype)
             for d in range(4)]
    out = d_sink + d_src + sum(d_nbr)
    inflow = sum(_shift_to(d_nbr[d], d) for d in range(4))
    cap = torch.stack([cap[d] - d_nbr[d] + _shift_to(d_nbr[OPP[d]], OPP[d])
                       for d in range(4)])
    return e - out + inflow, h, cap, cs - d_src, ct - d_sink, d_sink


def solve(cap_nbr, cap_src, cap_sink, *, rounds_per_heuristic: int,
          max_rounds: int, dtype=torch.float32) -> GridAnswer:
    """Max-flow and min cut of a batch: ``cap_nbr`` ``(B, 4, H, W)``,
    ``cap_src`` and ``cap_sink`` ``(B, H, W)``, on their device.

    Each cycle runs ``rounds_per_heuristic`` rounds and one global
    relabel on every instance; instances with no excess left (or at
    ``max_rounds``) keep their state from before the cycle.
    """
    H, W = cap_src.shape[-2:]
    n_nodes = H * W + 2
    cap = torch.movedim(cap_nbr, 1, 0).to(dtype).contiguous()
    cs = cap_src.to(dtype)
    ct = cap_sink.to(dtype)
    e = cs.clone()
    B = cs.shape[0]
    dev = cs.device
    flow = torch.zeros(B, dtype=dtype, device=dev)
    h = bfs_heights(cap, ct, torch.zeros_like(cs, dtype=torch.int32),
                    n_nodes)
    rounds = torch.zeros(B, dtype=torch.int32, device=dev)
    heur = torch.zeros(B, dtype=torch.int32, device=dev)
    while True:
        live = (e > 0).flatten(1).any(1) & (rounds < max_rounds)
        if not bool(live.any()):
            break
        ne, nh, ncap, ncs, nct, nflow = e, h, cap, cs, ct, flow
        for _ in range(rounds_per_heuristic):
            ne, nh, ncap, ncs, nct, d_sink = jacobi_round(
                ne, nh, ncap, ncs, nct, n_nodes)
            nflow = nflow + d_sink.sum((-2, -1))
        nh = bfs_heights(ncap, nct, nh, n_nodes)
        m = live[:, None, None]
        e, h = torch.where(m, ne, e), torch.where(m, nh, h)
        cap = torch.where(m[None], ncap, cap)
        cs, ct = torch.where(m, ncs, cs), torch.where(m, nct, ct)
        flow = torch.where(live, nflow, flow)
        rounds = rounds + torch.where(live, rounds_per_heuristic, 0).to(
            torch.int32)
        heur = heur + live.to(torch.int32)
    cut = bfs_heights(cap, ct, h, n_nodes) < n_nodes
    return GridAnswer(flow=flow, cut=cut, rounds=rounds, heuristics=heur,
                      converged=~(e > 0).flatten(1).any(1))


def cut_capacity(cap_nbr, cap_src, cap_sink, cut):
    """Capacity of the s-t cut whose sink side is ``cut`` ``(B, H, W)``,
    summed in float64 from the original capacities (``cap_nbr``
    ``(B, 4, H, W)``): the source-to-node edges into the sink side, the
    node-to-sink edges out of the source side, and the grid edges from
    the source side into the sink side."""
    f64 = torch.float64
    src_side = ~cut
    total = (cap_src.to(f64) * cut).sum((-2, -1))
    total += (cap_sink.to(f64) * src_side).sum((-2, -1))
    for d in range(4):
        nbr_sink = _nbr(cut, d, False)       # the neighbour's side
        total += (cap_nbr[:, d].to(f64) * (src_side & nbr_sink)).sum(
            (-2, -1))
    return total
