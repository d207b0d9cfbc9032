"""Flow-based MoE token -> expert routing (the paper's technique, first-class).

Counterpart of ``repro/core/routing.py``. The assignment problem the paper
solves (section 5) is the balanced-routing problem of MoE layers: tokens
are X, expert *slots* are Y, affinity logits are edge weights and expert
capacity is the per-Y-node supply. Three routers:

  * ``topk_route``    -- the standard baseline (top-k, then capacity
    truncation).
  * ``auction_route`` -- capacity-constrained eps-auction: the Jacobi
    bidding round of ``repro_torch.core.assignment`` generalised to
    capacities, run for a fixed number of rounds. At most k experts per
    token, at most ``capacity`` tokens per expert.
  * ``exact_route``   -- slot-expanded exact assignment through
    ``solve_assignment`` (small shapes, tests, the paper-faithful oracle).

``auction_route`` is what MoE configs select with ``router = "flow"``.

Every router takes ``scores`` of shape ``(T, E)`` or ``(..., T, E)`` and
routes all leading groups at once, on the scores' device. Given the same
scores the routers give the JAX package's dispatch, demand and prices bit
for bit: every op they decide with (subtract, top-k values, compare,
stable sorts, bool sums, argmax, add) is exact in IEEE arithmetic. Two
places need care: sorts are stable, as ``jnp.argsort`` is, and
``topk_route`` picks its k experts in ``lax.top_k``'s order (the total
order of the float bits, lower index first among equals). Combine weights
are softmaxes and agree to rounding.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.assignment.cost_scaling import solve_assignment

NEG = -1e9


class Routing(NamedTuple):
    dispatch: torch.Tensor   # (..., T, E) bool -- token t goes to expert e
    combine: torch.Tensor    # (..., T, E) float -- combine weights (0 if dropped)
    prices: torch.Tensor     # (..., E) final expert prices (auction only; else 0)
    demand: torch.Tensor     # (..., E) int32 tokens per expert


def _keep_topc_per_expert(score: torch.Tensor, picked: torch.Tensor,
                          capacity: int) -> torch.Tensor:
    """Per-expert capacity enforcement: keep the ``capacity`` best bidders
    (ties by token order, as the stable ``jnp.argsort``)."""
    bid = torch.where(picked, score, NEG)
    # rank of each token within its expert column, best first
    order = torch.argsort(-bid, dim=-2, stable=True)
    ranks = torch.empty_like(order).scatter_(
        -2, order, torch.arange(order.shape[-2], device=order.device)
        .view(-1, 1).expand(order.shape).contiguous())
    return picked & (ranks < capacity) & (bid > NEG / 2)


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys whose order is the total order of float32 ``x`` (-0.0
    below 0.0), the order ``lax.top_k`` picks by."""
    b = x.float().contiguous().view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def _topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The k entries of each row that ``lax.top_k`` returns, as a mask:
    largest first in the total order, the lower index first among equal
    bits."""
    idx = torch.sort(_total_order_key(scores), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return torch.zeros_like(scores, dtype=torch.bool).scatter_(-1, idx, True)


def _kth_largest(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest value of each row, keeping the axis (a value only:
    ``x >= kth`` then picks more than k on exact ties, as the reference)."""
    return torch.topk(x, k, dim=-1).values[..., -1:]


def _demand(kept: torch.Tensor) -> torch.Tensor:
    return kept.sum(-2, dtype=torch.int32)


def topk_route(scores: torch.Tensor, k: int, capacity: int) -> Routing:
    """Baseline: per-token top-k, then per-expert capacity truncation."""
    E = scores.shape[-1]
    picked = _topk_mask(scores, k)
    kept = _keep_topc_per_expert(scores, picked, capacity)
    gates = torch.softmax(torch.where(picked, scores, NEG), dim=-1)
    combine = torch.where(kept, gates, 0.0)
    return Routing(kept, combine,
                   scores.new_zeros(scores.shape[:-2] + (E,)),
                   _demand(kept))


def auction_route(scores: torch.Tensor, k: int, capacity: int,
                  n_iters: int = 8, eps: float = 1e-2) -> Routing:
    """Capacity-constrained eps-auction routing (paper technique, Jacobi
    rounds).

    Each round every token bids for its current best-k experts at
    price-adjusted affinity; oversubscribed experts raise their price to
    the marginal (capacity-th) bid plus eps, shedding the weakest bidders
    -- the dense-bipartite analogue of Algorithm 5.4's relabel. A fixed
    ``n_iters`` keeps the op static; the final truncation guarantees
    feasibility whatever the convergence state. Leading batch axes route
    every group at once (prices are per group).
    """
    T, E = scores.shape[-2:]
    s = scores.float()
    eps32 = torch.tensor(eps, dtype=torch.float32, device=s.device)

    q = s.new_zeros(s.shape[:-2] + (E,))
    if capacity < T:  # capacity >= T can never oversubscribe: prices stay 0
        for _ in range(n_iters):
            adj = s - q[..., None, :]
            picked = adj >= _kth_largest(adj, k)
            bids = torch.where(picked, adj, NEG)
            top_c1 = torch.topk(bids.transpose(-1, -2), capacity + 1,
                                dim=-1).values              # (..., E, C+1)
            over = _demand(picked) > capacity
            # relabel: raise the price by the gap between the capacity-th
            # and (capacity+1)-th bids + eps -- exactly sheds bidders below
            # the cut (the marginal bid plays Alg. 5.4's min c'_p)
            inc = torch.clamp_min(top_c1[..., capacity - 1]
                                  - top_c1[..., capacity], 0.0) + eps32
            q = torch.where(over, q + inc, q)

    adj = s - q[..., None, :]
    picked = adj >= _kth_largest(adj, k)
    kept = _keep_topc_per_expert(adj, picked, capacity)

    # Rescue passes: tokens shed by price rises re-bid for experts with
    # slack (bounded to 2 passes to keep the op static).
    experts = torch.arange(E, device=s.device)
    for _ in range(2):
        slots_used = kept.sum(-1, keepdim=True)                  # (..., T, 1)
        free = (capacity - kept.sum(-2))[..., None, :]           # (..., 1, E)
        want = torch.where(kept | (free <= 0) | (slots_used >= k), NEG, adj)
        best = torch.argmax(want, dim=-1, keepdim=True)
        valid = torch.gather(want, -1, best) > NEG / 2
        extra = (best == experts) & valid
        # re-enforce capacity with incumbents ranked strictly above rescuers
        rank_score = torch.where(kept, 1e6 + adj, adj)
        kept = _keep_topc_per_expert(rank_score, kept | extra, capacity)

    gates = torch.softmax(torch.where(kept | picked, s, NEG), dim=-1)
    combine = torch.where(kept, gates, 0.0).to(scores.dtype)
    return Routing(kept, combine, q, _demand(kept))


def exact_route(scores: torch.Tensor, capacity: int,
                weight_scale: int = 1000) -> Routing:
    """Exact k=1 balanced routing by slot-expanded assignment (paper
    section 5).

    Requires T == E * capacity (pad tokens to make it so). Every expert is
    replicated into ``capacity`` slots and the T x T assignment is solved
    with the cost-scaling algorithm (``solve_assignment``, its default
    ``backend="xla"``) on the scores' device; leading batch axes solve as
    one batch. Rows the solve leaves unmatched (only with a pathologically
    low ``max_rounds``) carry the >= T sentinel and map to an all-False
    dispatch row: those tokens are dropped, not sent to an arbitrary
    expert.
    """
    T, E = scores.shape[-2:]
    if T != E * capacity:
        raise ValueError("exact_route needs T == E * capacity")
    lead = scores.shape[:-2]
    w = torch.repeat_interleave(scores, capacity, dim=-1)    # (..., T, E*cap)
    w_i = torch.round(w * weight_scale).to(torch.int32)
    res = solve_assignment(w_i.reshape((-1, T, T)) if lead else w_i,
                           method="auction", device=scores.device)
    expert = (res.col_of_row // capacity).reshape(lead + (T,))  # slot -> expert
    dispatch = expert[..., None] == torch.arange(E, device=scores.device)
    gates = torch.softmax(torch.where(dispatch, scores, NEG), dim=-1)
    combine = torch.where(dispatch, gates, 0.0)
    # the mean as XLA computes it: a float32 sum times float32(1 / capacity)
    prices = (-res.p_y.reshape(lead + (E, capacity))).float().sum(-1) \
        * torch.tensor(1 / capacity, dtype=torch.float32)
    return Routing(dispatch, combine, prices.to(scores.dtype),
                   _demand(dispatch))


def solve_transportation(w, supply, capacity, weight_scale: int = 1,
                         device=None):
    """Exact max-weight transportation via slot expansion (paper section 5
    lineage).

    Integer supplies (per X node) and capacities (per Y node) are expanded
    into unit slots, solved as a square assignment with the cost-scaling
    solver, and folded back. Requires sum(supply) <= sum(capacity). Dummy
    rows absorb spare capacity at weight 0, so the solution is exactly
    optimal. Runs on ``w``'s device when ``w`` is a tensor, else on
    ``device`` (default cuda).

    Returns ``(flow, res)``: flow ``(n_x, n_y)`` int32 with row sums ==
    supply, column sums <= capacity, maximising sum(w * flow), and the
    assignment result. For exact k > 1 routing oracles and tests -- the
    production router is the approximate auction.
    """
    from repro_torch import resolve_device
    dev = w.device if isinstance(w, torch.Tensor) else resolve_device(device)
    w = torch.as_tensor(w, device=dev)
    n_x, n_y = w.shape
    supply = np.asarray(supply, np.int64)
    capacity = np.asarray(capacity, np.int64)
    if supply.sum() > capacity.sum():
        raise ValueError("infeasible transportation")
    rows = np.repeat(np.arange(n_x), supply)              # unit slots of X
    cols = np.repeat(np.arange(n_y), capacity)            # unit slots of Y
    n = int(capacity.sum())
    big = torch.zeros((n, n), dtype=torch.int32, device=dev)
    w_i = torch.round(w * weight_scale).to(torch.int32)
    big[:len(rows), :] = w_i[torch.as_tensor(rows, device=dev)][
        :, torch.as_tensor(cols, device=dev)]             # dummies stay 0
    res = solve_assignment(big, method="auction", device=dev)
    flow = np.zeros((n_x, n_y), np.int32)
    col_of_row = res.col_of_row[:len(rows)].cpu().numpy()
    ok = col_of_row < len(cols)  # unmatched sentinel when not converged
    np.add.at(flow, (rows[ok], cols[col_of_row[ok]]), 1)
    return torch.as_tensor(flow, device=dev), res
