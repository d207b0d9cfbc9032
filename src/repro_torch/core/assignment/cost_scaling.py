"""Cost-scaling assignment (max-weight perfect matching), paper §5.

PyTorch port of ``repro/core/assignment/cost_scaling.py``: the paper's
Algorithm 5.2 outer loop around the lock-free Refine of Algorithm 5.4, in
synchronous Jacobi rounds (every active node applies its push/relabel
decision to the pre-round state; the unit-flow updates touch disjoint
entries of the dense matching matrix F, so they commute).

Representation (complete bipartite, |X| = |Y| = n):
  * costs ``c[x, y] = -(n+1) * w[x, y]`` (minimization form; optimality at
    ε < 1 on the scaled costs is the exact optimum),
  * ``F[x, y]`` ∈ {0, 1}: the pseudoflow, dense int32,
  * prices ``p_x``, ``p_y``; part-reduced cost ``c'_p(x, y) = c(x, y) -
    p(y)``.

Heuristics of §5.2/§5.5: arc fixing (an accumulating mask of arcs with
``c_p > 2nε``) and the price update (a Bellman–Ford sweep over the dense
bipartite graph, with one host sync per sweep). ``method="auction"`` is
the beyond-paper top-2 bidding refine, ``"pushrelabel"`` the paper's
Algorithm 5.4. Under ``backend="pallas"`` both rounds take their row
minima from K4 (``repro_torch.kernels.bidding``).

Every function is shape-polymorphic over leading batch axes: ``w`` may be
``(n, n)`` or ``(B, n, n)``, ε and the counters are per instance. The
nested ε-scaling/refine loops are flattened into one per-instance cycle
(``_ScaleState``) driven by ``repro_torch.core.solver_loop.run_masked``,
so a batch equals a loop of single solves.

Parity with the reference: every cost, price and counter is int32 and
wraps as int32 arithmetic does in JAX; integer division floors
(``torch.div(..., rounding_mode="floor")``); argmin and argmax take the
first index among equal values.

Entry points run on the card unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.masking import freeze
from repro_torch.core.solver_loop import LoopSpec, run_compacted, run_masked
from repro_torch.kernels.bidding.ops import bidding_op

INF = 2 ** 30
INF_D = 2 ** 26          # price-update distance infinity (sums stay int32)
METHODS = ("auction", "pushrelabel")
BACKENDS = ("xla", "pallas")
_I32 = torch.int32


class AssignmentResult(NamedTuple):
    col_of_row: torch.Tensor  # (..., n) int32: matched y per x; sentinel n
    #                           marks an UNMATCHED row (only when not
    #                           converged)
    weight: torch.Tensor      # (...,) int32 total weight (original scale)
    p_x: torch.Tensor
    p_y: torch.Tensor
    rounds: torch.Tensor      # (...,) int32 Jacobi rounds across refines
    pushes: torch.Tensor      # (...,) int32 pushes (paper's op count)
    relabels: torch.Tensor    # (...,) int32 relabel operations
    converged: torch.Tensor


class _RefineState(NamedTuple):
    F: torch.Tensor
    p_x: torch.Tensor
    p_y: torch.Tensor
    fixed: torch.Tensor      # accumulating arc-fixing mask (True = deleted)
    rounds: torch.Tensor
    pushes: torch.Tensor
    relabels: torch.Tensor


def _masked(c, fixed):
    return torch.where(fixed, INF, c)


def _exp(eps, k: int):
    """ε with k broadcast axes appended: per-instance ε against (..., n[, n])."""
    return eps.reshape(tuple(eps.shape) + (1,) * k)


def _freeze(live, new: _RefineState, old: _RefineState) -> _RefineState:
    """Keep ``old`` leaves where ``live`` is False (per-instance no-op)."""
    return freeze(live, new, old)


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _count(*masks) -> torch.Tensor:
    """Sum of per-row bool masks over the last axis, as int32 (a torch sum
    of bools is int64; the reference's is int32)."""
    return sum(m.sum(-1, dtype=_I32) for m in masks)


def _one_hot(idx, n: int, axis: int = -1) -> torch.Tensor:
    """Bool one-hot of ``idx`` with the new axis of length ``n`` at
    ``axis`` (-1: after, -2: before the last axis of ``idx``)."""
    ar = torch.arange(n, device=idx.device)
    if axis == -1:
        return idx.unsqueeze(-1) == ar
    return ar.unsqueeze(-1) == idx.unsqueeze(-2)


def _round_pushrelabel(c, eps, st: _RefineState, *,
                       backend: str = "xla") -> _RefineState:
    """One Jacobi round of Algorithm 5.4 over all active nodes of both sides."""
    F, p_x, p_y, fixed = st.F, st.p_x, st.p_y, st.fixed
    e1 = _exp(eps, 1)

    active_x = F.sum(-1) == 0           # e(x) = 1
    active_y = F.sum(-2) > 1            # e(y) > 0

    # ---- X side: min part-reduced cost over residual (x,y) = unmatched arcs.
    if backend == "pallas":  # the paper's hot loop as the bidding kernel
        min_cpx, arg_x, _ = bidding_op(c, p_y, fixed | (F == 1))
    else:
        cpx = _masked(c - p_y.unsqueeze(-2), fixed)
        cpx = torch.where(F == 1, INF, cpx)     # residual X->Y iff F == 0
        min_cpx = torch.amin(cpx, dim=-1)
        arg_x = torch.argmin(cpx, dim=-1)
    admis_x = min_cpx < -p_x                     # c_p(x, ỹ) < 0 (line 11)
    push_x = active_x & admis_x & (min_cpx < INF)
    relab_x = active_x & ~admis_x & (min_cpx < INF)
    p_x = torch.where(relab_x, -(min_cpx + e1), p_x)     # line 18

    # ---- Y side: residual (y,x) iff F[x,y] == 1; c'_p(y,x) = -c(x,y) - p(x).
    cpy = torch.where(F == 1, -c - p_x.unsqueeze(-1), INF)  # (x, y) layout
    min_cpy = torch.amin(cpy, dim=-2)
    arg_y = torch.argmin(cpy, dim=-2)
    admis_y = min_cpy < -p_y
    push_y = active_y & admis_y & (min_cpy < INF)
    relab_y = active_y & ~admis_y & (min_cpy < INF)
    p_y = torch.where(relab_y, -(min_cpy + e1), p_y)

    # ---- fulfillment: apply all unit pushes at once (disjoint F entries).
    n = c.shape[-1]
    add = (_one_hot(arg_x, n) & push_x.unsqueeze(-1)).to(_I32)
    rem = (_one_hot(arg_y, n, axis=-2) & push_y.unsqueeze(-2)).to(_I32)
    F = torch.clamp(F + add - rem, 0, 1)

    return _RefineState(
        F=F, p_x=p_x, p_y=p_y, fixed=fixed,
        rounds=st.rounds + 1,
        pushes=st.pushes + _count(push_x, push_y),
        relabels=st.relabels + _count(relab_x, relab_y),
    )


def _round_auction(c, eps, st: _RefineState, *,
                   backend: str = "xla") -> _RefineState:
    """Beyond-paper refine round: top-2 bidding (push+relabel fused).

    Every unmatched x bids its best y down to the second-best level minus
    ε, and each y accepts the single best bid, evicting the previous
    owner. One round does a push AND the price move a later relabel would.
    """
    F, p_x, p_y, fixed = st.F, st.p_x, st.p_y, st.fixed
    n = c.shape[-1]
    e1 = _exp(eps, 1)

    active_x = F.sum(-1) == 0

    if backend == "pallas":  # top-2 bid via the bidding kernel
        min1, arg1, min2 = bidding_op(c, p_y, fixed)
    else:
        cpx = _masked(c - p_y.unsqueeze(-2), fixed)  # part-reduced costs
        min1 = torch.amin(cpx, dim=-1)
        arg1 = torch.argmin(cpx, dim=-1)
        min2 = torch.amin(torch.where(_one_hot(arg1, n), INF, cpx), dim=-1)
    arg1 = arg1.long()
    min2 = torch.where(min2 >= INF, min1, min2)   # single-candidate rows

    # the bid strength (lower is stronger) is min1 - (min2 + ε) <= -ε < 0
    bid_strength = min1 - min2 - e1
    bids = torch.where(_one_hot(arg1, n) & active_x.unsqueeze(-1),
                       bid_strength.unsqueeze(-1), INF)
    best_bid = torch.amin(bids, dim=-2)
    winner = torch.argmin(bids, dim=-2)
    got_bid = best_bid < INF

    # y accepts the winner: the previous owner (if any) is evicted.
    new_match = (_one_hot(winner, n, axis=-2)
                 & got_bid.unsqueeze(-2)).to(_I32)
    F = F * (~got_bid).unsqueeze(-2).to(_I32) + new_match
    # p(y) absorbs the bid (a Bertsekas raise in Goldberg coordinates)
    p_y = torch.where(got_bid, p_y + best_bid, p_y)
    # the winner's own price moves as the later relabel would (ε-CS witness)
    rows = torch.arange(n, device=c.device)
    won = (active_x & (torch.gather(winner, -1, arg1) == rows)
           & torch.gather(got_bid, -1, arg1))
    p_x = torch.where(won, -(min2 + e1), p_x)

    n_push = _count(got_bid)
    return _RefineState(
        F=F, p_x=p_x, p_y=p_y, fixed=fixed,
        rounds=st.rounds + 1,
        pushes=st.pushes + n_push,
        relabels=st.relabels + n_push,
    )


def _is_perfect(F):
    """Per-instance perfect-matching predicate: scalar or (B,) bool."""
    n = F.shape[-1]
    return ((F.sum((-2, -1)) == n)
            & (F.sum(-2) <= 1).all(-1)
            & (F.sum(-1) <= 1).all(-1))


def price_update(c, eps, st: _RefineState, max_sweeps: int) -> _RefineState:
    """Price-update heuristic (paper Alg. 5.3, Bellman–Ford form).

    Distances (in ε units) from every deficit node (unmatched y) backwards
    along residual arcs; then p(v) -= ε·l(v). The arc length of residual
    (v,w) is max(0, floor(c_p(v,w)/ε) + 1). The sweep loop is a host loop
    with the reference's cond-before-body structure: one sync per sweep on
    the batch-wide ``changed`` flag, at most ``max_sweeps`` sweeps; a
    sweep on an instance at its fixpoint is an exact no-op.
    """
    F, p_x, p_y = st.F, st.p_x, st.p_y
    e1, e2 = _exp(eps, 1), _exp(eps, 2)
    l_y0 = torch.where(F.sum(-2) == 0, 0, INF_D).to(_I32)

    cp_xy = _masked(c + p_x.unsqueeze(-1) - p_y.unsqueeze(-2), st.fixed)
    len_xy = torch.clamp(_floordiv(cp_xy, e2) + 1, 0, INF_D)   # arc X->Y
    len_xy = torch.where((F == 0) & (cp_xy < INF), len_xy, INF_D)
    cp_yx = -c + p_y.unsqueeze(-2) - p_x.unsqueeze(-1)
    len_yx = torch.where(F == 1, torch.clamp(_floordiv(cp_yx, e2) + 1, 0,
                                             INF_D), INF_D)

    l_x, l_y = torch.full_like(p_x, INF_D), l_y0
    changed, it = True, 0
    while changed and it < max_sweeps:
        nl_x = torch.amin(torch.clamp(len_xy + l_y.unsqueeze(-2), max=INF_D),
                          dim=-1)
        nl_x = torch.minimum(l_x, nl_x)
        # y relaxes through residual (y, x) arcs using the fresh l_x
        nl_y = torch.amin(torch.clamp(len_yx + nl_x.unsqueeze(-1), max=INF_D),
                          dim=-2)
        nl_y = torch.minimum(torch.minimum(l_y, nl_y), l_y0)
        changed = bool(((nl_x != l_x).any() | (nl_y != l_y).any()).item())
        l_x, l_y, it = nl_x, nl_y, it + 1

    reach_x, reach_y = l_x < INF_D, l_y < INF_D
    last = torch.maximum(torch.where(reach_x, l_x, 0).amax(-1),
                         torch.where(reach_y, l_y, 0).amax(-1))
    l_x = torch.where(reach_x, l_x, last.unsqueeze(-1) + 1)
    l_y = torch.where(reach_y, l_y, last.unsqueeze(-1) + 1)
    return st._replace(p_x=st.p_x - e1 * l_x, p_y=st.p_y - e1 * l_y)


class _ScaleState(NamedTuple):
    """Flattened per-instance ε-scaling carry for the solver-loop runtime.

    Alg. 5.2's ε schedule around Alg. 5.4's refine, flattened into ONE
    cycle: each instance carries its own in-flight ε, its Jacobi-round
    count within the current refine and its schedule-liveness flag, and
    the cycle performs refine-exit transitions (arc fixing, ε downstep,
    refine re-init) per instance the moment ITS refine finishes.
    """

    c: torch.Tensor      # (..., n, n) scaled costs (per-instance constants)
    eps: torch.Tensor    # (...,) ε of the refine currently in flight
    k: torch.Tensor      # (...,) Jacobi rounds inside the current refine
    alive: torch.Tensor  # (...,) bool: ε schedule not yet finished
    st: _RefineState


def _refine_init(c, eps, st: _RefineState) -> _RefineState:
    """Refine entry (Alg. 5.2 lines 3-6): strip the flow, reprice X —
    ``F <- 0; p(x) <- -min_y (c'_p(x,y) + eps)``."""
    cpx = _masked(c - st.p_y.unsqueeze(-2), st.fixed)
    return st._replace(F=torch.zeros_like(st.F),
                       p_x=-(torch.amin(cpx, dim=-1) + _exp(eps, 1)))


def _ceil_div(a, b: int):
    return -_floordiv(-a, b)


def _scaled(w, alpha: int):
    """Scaled minimization costs ``c = -(n+1) w`` and the cold first ε,
    ``ceil(max|c| / alpha)`` per instance. ``w`` is an int32 tensor."""
    n = w.shape[-1]
    c = -(n + 1) * w                                        # minimization form
    C = torch.clamp(torch.amax(torch.abs(c), dim=(-2, -1)), min=1)
    return c, torch.clamp(_ceil_div(C, alpha), min=1)       # ceil(C/alpha)


def _enter(c, eps0, p_y) -> _ScaleState:
    """The flat state entering its first refine at ``eps0`` with column
    prices ``p_y`` (Alg. 5.0 start)."""
    n = c.shape[-1]
    batch = tuple(c.shape[:-2])
    zeros = lambda shape, dt=_I32: torch.zeros(shape, dtype=dt,  # noqa: E731
                                               device=c.device)
    st = _RefineState(
        F=zeros(batch + (n, n)), p_x=zeros(batch + (n,)), p_y=p_y,
        fixed=zeros(batch + (n, n), torch.bool), rounds=zeros(batch),
        pushes=zeros(batch), relabels=zeros(batch))
    return _ScaleState(c=c, eps=eps0, k=zeros(batch),
                       alive=torch.ones(batch, dtype=torch.bool,
                                        device=c.device),
                       st=_refine_init(c, eps0, st))


def _scale_init(w, *, alpha: int) -> _ScaleState:
    """Initial flat state: per-instance ε = ceil(max|c| / alpha), first
    refine entered (Alg. 5.0 start). ``w`` is an int32 tensor."""
    c, eps0 = _scaled(w, alpha)
    return _enter(c, eps0, torch.zeros(tuple(w.shape[:-1]), dtype=_I32,
                                       device=w.device))


def _scale_warm(w, p_y, dmax, *, alpha: int) -> _ScaleState:
    """Warm flat state: re-enter the ε ladder at a delta-bounded rung with
    the prior column prices (reference ``_scale_warm``).

    ``_refine_init`` makes the empty flow EXACTLY ε-optimal for ANY
    ``p_y``, so warm correctness is unconditional: the ladder still ends
    at ε = 1. The prior prices only change how much work is left: prices
    1-optimal for the base costs are ``(1 + D)``-optimal for the mutated
    ones, ``D = max |Δc|`` in scaled units, so the ladder starts at
    ``clip(1 + D, 1, ε_cold)``. ``w`` is an int32 tensor, ``p_y`` and
    ``dmax`` (per-instance ``D``, at most ``2 ** 30``) int32 tensors.
    """
    c, eps_cold = _scaled(w, alpha)
    eps0 = torch.minimum(torch.clamp(1 + dmax.to(_I32), min=1), eps_cold)
    return _enter(c, eps0, p_y.to(_I32))


@functools.lru_cache(maxsize=None)
def _assignment_spec(method: str, alpha: int, max_rounds: int,
                     rounds_per_heuristic: int, use_price_update: bool,
                     use_arc_fixing: bool, backend: str) -> LoopSpec:
    """The assignment solver's registration with the solver-loop runtime,
    cached per static-knob tuple (one spec object per configuration).

    One cycle = ``rounds_per_heuristic`` Jacobi rounds, the price-update
    sweep (paper Alg. 5.3) and, for instances whose refine just finished
    (perfect matching or ``max_rounds`` hit), the refine-exit transition:
    arc fixing at the finished ε, ε downstep, and re-entry into the next
    refine (or schedule death after the ε = 1 pass).
    """
    round_fn = {"pushrelabel": _round_pushrelabel,
                "auction": _round_auction}[method]

    def cycle(s: _ScaleState) -> _ScaleState:
        c, eps, k, alive, st = s
        n = c.shape[-1]
        new = st
        for _ in range(rounds_per_heuristic):
            new = round_fn(c, eps, new, backend=backend)
        if use_price_update:
            perf = _is_perfect(new.F)
            if perf.dim() == 0:  # single instance: genuinely skip the sweep
                if not bool(perf):
                    new = price_update(c, eps, new, max_sweeps=2 * n)
            else:
                new = _freeze(~perf,
                              price_update(c, eps, new, max_sweeps=2 * n),
                              new)
        k = k + rounds_per_heuristic
        done = _is_perfect(new.F) | (k >= max_rounds)
        if use_arc_fixing:
            # Arc fixing at refine exit (paper §5.2): an unmatched arc with
            # c_p > 2nε carries zero flow in every ε'-optimal flow with
            # ε' <= ε, so it is frozen for all later refines.
            cp = c + new.p_x.unsqueeze(-1) - new.p_y.unsqueeze(-2)
            fix = new.fixed | ((cp > 2 * n * _exp(eps, 2)) & (new.F == 0))
            new = new._replace(fixed=torch.where(
                done.unsqueeze(-1).unsqueeze(-1), fix, new.fixed))
        # ε schedule step for finished refines: divide down, or die after
        # the ε = 1 pass (1-optimal on scaled costs = exact optimum).
        still = alive & ~(done & (eps <= 1))
        eps_next = torch.where(done & (eps > 1),
                               torch.clamp(_ceil_div(eps, alpha), min=1), eps)
        new = _freeze(done & still, _refine_init(c, eps_next, new), new)
        return _ScaleState(c=c, eps=eps_next,
                           k=torch.where(done, 0, k).to(_I32),
                           alive=still, st=new)

    def live(s: _ScaleState, rounds: torch.Tensor) -> torch.Tensor:
        return s.alive

    return LoopSpec(cycle=cycle, live=live,
                    rounds_per_cycle=rounds_per_heuristic, lead_axes_fn=None)


def _assignment_finalize(w, st: _RefineState) -> AssignmentResult:
    """Matching, weight (original scale), and convergence from a final state.

    Unmatched rows (all-zero F row — possible only when ``max_rounds`` was
    hit before a perfect matching) get the sentinel ``n``; matched rows get
    their argmax column.
    """
    n = w.shape[-1]
    matched = st.F.sum(-1) > 0
    col = torch.where(matched, torch.argmax(st.F, dim=-1), n).to(_I32)
    picked = torch.gather(w, -1, torch.clamp(col, max=n - 1).long()
                          .unsqueeze(-1)).squeeze(-1)
    weight = torch.where(matched, picked, 0).sum(-1, dtype=_I32)
    return AssignmentResult(
        col_of_row=col, weight=weight, p_x=st.p_x, p_y=st.p_y,
        rounds=st.rounds, pushes=st.pushes, relabels=st.relabels,
        converged=_is_perfect(st.F),
    )


def _load_weights(w, device: torch.device) -> torch.Tensor:
    """An int32 copy of integer weights (numpy array or tensor)."""
    if isinstance(w, torch.Tensor):
        return w.to(device=device, dtype=_I32, copy=True)
    return torch.tensor(np.asarray(w).astype(np.int32), device=device)


def solve_assignment(
    w,
    *,
    method: str = "auction",
    alpha: int = 10,
    max_rounds: int = 200_000,
    rounds_per_heuristic: int = 16,
    use_price_update: bool = True,
    use_arc_fixing: bool = True,
    backend: str = "xla",
    compact: bool = False,
    mesh=None,
    mesh_axis: str | None = None,
    device=None,
) -> AssignmentResult:
    """Max-weight perfect matching on a complete bipartite graph (paper §5).

    Args:
      w: integer weight matrix (numpy array or tensor) — ``(n, n)`` for one
        instance or ``(B, n, n)`` for a batch. Integer weights only (the
        (n+1)-scaling argument is exact on integers); ``n * (n+1) *
        max|w|`` must fit in int32.
      method: ``"auction"`` (top-2 bidding refine, fewer rounds) or
        ``"pushrelabel"`` (the paper's Algorithm 5.4).
      alpha: ε-scaling divisor; 10 is the paper's factor (§5.5).
      max_rounds: per-refine Jacobi-round cap; an instance that hits it
        reports ``converged=False`` and may leave rows unmatched (their
        ``col_of_row`` entries hold the sentinel ``n``).
      rounds_per_heuristic: Jacobi rounds between price-update sweeps.
      use_price_update: run the Bellman–Ford price update (Alg. 5.3).
      use_arc_fixing: freeze arcs with ``c_p > 2nε`` between refines.
      backend: ``"xla"`` (plain tensor code) or ``"pallas"`` (the bidding
        stage on K4, ``repro_torch.kernels.bidding``); equal results.
      compact: early-exit compaction (``repro_torch.core.solver_loop``;
        batched ``(B, n, n)`` weights only): instances whose ε schedule
        finished leave the working set between cycles instead of being
        select-masked until the batch drains; equal results.
      mesh / mesh_axis: optional lane set
        (``repro_torch.launch.mesh.make_solver_mesh``; batched ``w``
        only): each lane solves a contiguous slice of the batch on its
        device, padded with zero (inert) instances where the batch does
        not divide; with ``compact=True`` compaction stays within each
        lane. Equal results, returned on ``device``.
      device: where to solve; ``None`` means ``"cuda"`` (raises without a
        card), ``"cpu"`` runs K4's plain version.

    Returns:
      ``AssignmentResult`` whose leaves lead with the batch axes of ``w``:
      ``col_of_row (..., n)``, ``weight (...,)`` on the original scale,
      prices ``p_x``/``p_y (..., n)``, the int32 counters and
      ``converged`` (True = the final 1-optimal flow is an exact optimum).
      Each instance runs its own ε schedule and is frozen once it
      finishes, so a batch equals a loop of single solves.
    """
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; valid: "
                         f"{', '.join(METHODS)}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; valid: "
                         f"{', '.join(BACKENDS)}")
    if compact and w.ndim != 3:
        raise ValueError(
            f"compact=True needs batched (B, n, n) weights, got shape "
            f"{tuple(w.shape)}; compaction drops converged instances from "
            f"a batch axis")
    if w.ndim not in (2, 3) or w.shape[-1] != w.shape[-2]:
        raise ValueError(f"w must be (n, n) or (B, n, n), got "
                         f"{tuple(w.shape)}")
    w_i = _load_weights(w, resolve_device(device))
    kw = dict(method=method, alpha=alpha, max_rounds=max_rounds,
              rounds_per_heuristic=rounds_per_heuristic,
              use_price_update=use_price_update,
              use_arc_fixing=use_arc_fixing, backend=backend)
    if mesh is None:
        return _solve_assignment_impl(w_i, compact=compact, **kw)
    if w.ndim != 3:
        raise ValueError(
            f"mesh-sharded solve_assignment needs batched (B, n, n) weights, "
            f"got shape {tuple(w.shape)}")
    from repro_torch.launch.mesh import dispatch_sharded
    return dispatch_sharded(_solve_assignment_impl, (w_i,), w.shape[0], mesh,
                            mesh_axis, compact=compact, **kw)


def _solve_assignment_impl(w_i, *, method, alpha, max_rounds,
                           rounds_per_heuristic, use_price_update,
                           use_arc_fixing, backend, compact=False,
                           lanes=None) -> AssignmentResult:
    """The solve on int32 weights already on the device, rank-polymorphic;
    ``compact`` (batched) drives ``run_compacted`` over ``lanes``."""
    state = _scale_init(w_i, alpha=alpha)
    spec = _assignment_spec(method, alpha, max_rounds, rounds_per_heuristic,
                            use_price_update, use_arc_fixing, backend)
    if compact:
        state, _ = run_compacted(spec, state, w_i.shape[0], lanes=lanes)
    else:
        state, _ = run_masked(spec, state, tuple(state.eps.shape))
    return _assignment_finalize(w_i, state.st)
