"""Synchronous data-parallel push-relabel max-flow on 2D grid graphs.

PyTorch port of ``repro/core/maxflow/grid.py`` (the paper's §4, Hong's
lock-free push-relabel). One Jacobi round applies the per-node decision to
EVERY node simultaneously:

  * each active node (e > 0) finds its lowest residual neighbour (sink at
    height 0, the four grid neighbours, source at height N),
  * if strictly lower, it pushes ``min(e, cap)`` toward it,
  * otherwise it relabels to ``h(ỹ) + 1``.

Concurrent ``e(y) += δ`` updates become one shift-and-add deposit per
round. The global/gap relabel is a min-plus wavefront BFS from the sink,
run every ``rounds_per_heuristic`` rounds by the K3 sweep kernel.

Grid layout: ``cap[d, ..., i, j]`` is the residual capacity of the edge
from node (i, j) toward its neighbour in direction d ∈ {UP, DOWN, LEFT,
RIGHT}; internally ``cap`` is ``(4, ..., H, W)`` (direction axis first),
every other plane ``(..., H, W)``. Batched results use the public layout,
``cap`` ``(B, 4, H, W)``.

Exactness: ``e``, the capacities and the flow sums are float32. On
integer-valued instances (every generator in ``ref.py``) each value and
each per-instance sum is an integer below 2**24, so every float32
operation here is exact and the port reproduces the reference bit for bit
whatever order a sum is taken in.

Entry points run on the card unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.solver_loop import LoopSpec, run_compacted, run_masked

UP, DOWN, LEFT, RIGHT = 0, 1, 2, 3
_OPP = (DOWN, UP, RIGHT, LEFT)
INF_H = 2 ** 30          # int32 height "infinity"; INF_H + 1 still fits


class GridProblem(NamedTuple):
    """A grid-cut instance (the Kolmogorov graph construction)."""

    cap_nbr: torch.Tensor   # (4, H, W) neighbour capacities
    cap_src: torch.Tensor   # (H, W) capacity of s -> x
    cap_sink: torch.Tensor  # (H, W) capacity of x -> t


class GridFlowState(NamedTuple):
    e: torch.Tensor          # (..., H, W) excess, float32
    h: torch.Tensor          # (..., H, W) heights, int32
    cap: torch.Tensor        # (4, ..., H, W) residual neighbour capacities
    cap_src: torch.Tensor    # (..., H, W) residual x -> s (returns excess)
    cap_sink: torch.Tensor   # (..., H, W) residual x -> t
    sink_flow: torch.Tensor  # (...,) total flow delivered to the sink
    src_flow: torch.Tensor   # (...,) total flow returned to the source
    # (...,) int32 count of global-relabel invocations per instance,
    # excluding the round-0 init BFS. None = untracked (hand-built states).
    heur: torch.Tensor | None = None


class GridFlowResult(NamedTuple):
    flow: torch.Tensor        # (...,) max-flow value(s)
    cut: torch.Tensor         # (..., H, W) bool, True = sink side of the cut
    state: GridFlowState      # maxflow_grid_batch returns cap (B, 4, H, W)
    rounds: torch.Tensor      # (...,) int32 Jacobi rounds per instance
    converged: torch.Tensor   # (...,) bool
    heuristics: torch.Tensor | None = None   # (...,) see GridFlowState.heur


def _nbr_h(h: torch.Tensor, d: int) -> torch.Tensor:
    """Height of the neighbour in direction d, INF_H outside the grid.

    Operates on the last two (H, W) axes; leading batch axes pass through.
    """
    out = torch.full_like(h, INF_H)
    if d == UP:
        out[..., 1:, :] = h[..., :-1, :]
    elif d == DOWN:
        out[..., :-1, :] = h[..., 1:, :]
    elif d == LEFT:
        out[..., :, 1:] = h[..., :, :-1]
    else:
        out[..., :, :-1] = h[..., :, 1:]
    return out


def _move(a: torch.Tensor, d: int) -> torch.Tensor:
    """Deposit a[x] at x's neighbour in direction d (zero fill at border)."""
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


def _gsum(a: torch.Tensor) -> torch.Tensor:
    """Per-instance grid sum: reduce the trailing (H, W) axes only."""
    return a.sum(dim=(-2, -1))


def _any_hw(a: torch.Tensor) -> torch.Tensor:
    """Per-instance ``any`` over the trailing (H, W) axes."""
    return a.flatten(-2).any(-1)


def jacobi_round(state: GridFlowState, n_nodes: int) -> GridFlowState:
    """One synchronous push/relabel round over every node, as plain tensor
    ops (the reference's ``backend="xla"`` round).

    The decision is the plain version of K1 (``grid_push_decide_ref``),
    the deposit the shared shift-add ``_deposit``. Shape-polymorphic over
    leading batch axes; a converged instance is an exact no-op.
    """
    from repro_torch.kernels.grid_push.ops import _deposit
    from repro_torch.kernels.grid_push.ref import grid_push_decide_ref
    h_new, delta = grid_push_decide_ref(state.e, state.h, state.cap,
                                        state.cap_src, state.cap_sink,
                                        n_nodes)
    return _deposit(state, h_new, delta)


def jacobi_round_multipush(state: GridFlowState,
                           n_nodes: int) -> GridFlowState:
    """Beyond-paper round: push to EVERY strictly-lower residual neighbour
    (priority: sink, source, then the grid directions); relabel only the
    nodes that could push nowhere.
    """
    from repro_torch.kernels.grid_push.ops import _deposit
    e, h, cap, cap_src, cap_sink = state[:5]
    active = e > 0
    inf = torch.full_like(h, INF_H)

    cand_h = [torch.where(cap_sink > 0, torch.zeros_like(h), inf),
              torch.where(cap_src > 0, torch.full_like(h, n_nodes), inf)]
    cand_h += [torch.where(cap[d] > 0, _nbr_h(h, d), inf) for d in range(4)]
    cand_cap = [cap_sink, cap_src] + [cap[d] for d in range(4)]

    remaining = torch.where(active, e, torch.zeros_like(e))
    deltas = []
    pushed_any = torch.zeros_like(active)
    for ch, cc in zip(cand_h, cand_cap):
        ok = active & (h > ch)
        d = torch.where(ok, torch.minimum(remaining, cc), torch.zeros_like(e))
        remaining = remaining - d
        pushed_any = pushed_any | (d > 0)
        deltas.append(d)

    h_min = torch.minimum(
        torch.minimum(cand_h[0], cand_h[1]),
        torch.minimum(torch.minimum(cand_h[2], cand_h[3]),
                      torch.minimum(cand_h[4], cand_h[5])))
    do_relabel = active & ~pushed_any & (h <= h_min) & (h_min < INF_H)
    h_new = torch.where(do_relabel, h_min + 1, h)
    return _deposit(state, h_new, torch.stack(deltas))


def bfs_heights(cap: torch.Tensor, cap_sink: torch.Tensor,
                h_prev: torch.Tensor, n_nodes: int,
                max_iters: int) -> torch.Tensor:
    """Backwards BFS from the sink (paper Alg. 4.4) plus gap relabel.

    Min-plus wavefront: h(x) = 1 if residual x->t, else 1 + min over
    residual out-edges (x, y) of h(y). Unreached nodes (the 'gap') get
    ``max(h_prev, N)``. The sweeps run on K3 with the source plane off,
    ``SWEEPS`` per call and one host sync per call; the last call is cut
    to ``max_iters - it`` sweeps, so exactly ``max_iters`` sweeps run when
    the cap binds. Sweeps past the fixpoint are no-ops, so the result
    equals the reference's one-sweep-per-iteration loop.
    """
    from repro_torch.kernels.bfs_relabel.kernel import (SWEEPS,
                                                        bfs_relabel_sweeps)
    *batch, H, W = h_prev.shape
    B = int(np.prod(batch, dtype=np.int64))
    cap4 = cap.reshape(4, B, H, W)
    seed = torch.where(cap_sink > 0, 1, INF_H).to(torch.int32).reshape(
        B, H, W)
    dt, it, changed = seed, 0, True
    while changed and it < max_iters:
        k = min(SWEEPS, max_iters - it)
        dt, _, flag = bfs_relabel_sweeps(cap4, seed, None, dt, None,
                                         sweeps=k)
        it += k
        changed = bool(flag)
    h = dt.reshape(h_prev.shape)
    return torch.where(h >= INF_H, torch.clamp_min(h_prev, n_nodes), h)


def check_no_violations(state: GridFlowState) -> torch.Tensor:
    """True iff no residual edge (x,y) has h(x) > h(y)+1 (per instance).

    Accepts both public layouts: ``maxflow_grid`` states (``cap``
    ``(4, H, W)``) and ``maxflow_grid_batch`` results (``cap``
    ``(B, 4, H, W)``).
    """
    cap = state.cap
    if state.h.dim() > 2:  # batched public layout -> internal (4, B, H, W)
        cap = torch.movedim(cap, -3, 0)
    ok = torch.ones(state.h.shape[:-2], dtype=torch.bool,
                    device=state.h.device)
    for d in range(4):
        viol = (cap[d] > 0) & (state.h > _nbr_h(state.h, d) + 1)
        ok &= ~_any_hw(viol)
    return ok


VALID_BACKENDS = ("xla", "multipush", "pallas", "balanced")


def _round_fn(backend: str):
    """Jacobi-round implementation for a backend flag; unknown strings
    raise ``ValueError``.

    ``"xla"`` keeps the reference's name: the round written as plain
    tensor ops. ``"pallas"`` runs the decision on K1, ``"balanced"`` on K2
    over active tiles.
    """
    if backend == "pallas":
        from repro_torch.kernels.grid_push.ops import jacobi_round_pallas
        return jacobi_round_pallas
    if backend == "multipush":
        return jacobi_round_multipush
    if backend == "balanced":
        from repro_torch.kernels.grid_push.ops import jacobi_round_scheduled
        return lambda s, n: jacobi_round_scheduled(s, n)[0]
    if backend == "xla":
        return jacobi_round
    raise ValueError(
        f"unknown maxflow backend {backend!r}; valid backends: "
        f"{', '.join(VALID_BACKENDS)}")


@functools.lru_cache(maxsize=None)
def _grid_spec(rounds_per_heuristic: int, max_rounds: int,
               bfs_max_iters: int, backend: str,
               stall_threshold: float = 0.05) -> LoopSpec:
    """The grid solver's registration with the solver-loop runtime,
    cached per static-knob tuple (one spec object per configuration).

    Every backend's cycle is exactly ``rounds_per_heuristic`` rounds. The
    fixed-cadence backends end it with an unconditional global relabel;
    ``"balanced"`` ends it with a STALL-DRIVEN bidirectional one: a
    per-instance EWMA of terminal-retired flow per unit remaining excess
    decides which instances relabel, and a host branch skips the pass when
    none stalled. Both are per-instance pure, so batched solves equal a
    loop of single ones.
    """
    round_fn = _round_fn(backend)
    if backend == "balanced":
        from repro_torch.kernels.bfs_relabel.ops import bfs_relabel_heights
        from repro_torch.kernels.grid_push.ops import jacobi_round_scheduled

    def _count_heur(new: GridFlowState, invoked) -> GridFlowState:
        if new.heur is None:
            return new
        return new._replace(heur=new.heur + invoked.to(torch.int32))

    def cycle(state: GridFlowState) -> GridFlowState:
        H, W = state.e.shape[-2:]
        n_nodes = H * W + 2
        iters = bfs_max_iters or n_nodes

        if backend == "balanced":
            s = state
            ewma = torch.ones(state.e.shape[:-2], dtype=torch.float32,
                              device=state.e.device)
            for _ in range(rounds_per_heuristic):
                remaining = torch.clamp_min(_gsum(s.e), 1.0)
                s, retired = jacobi_round_scheduled(s, n_nodes)
                # EWMA (alpha 1/2, float32) of the excess RETIRED at a
                # terminal this round per unit of excess still in flight.
                ewma = 0.5 * ewma + 0.5 * (retired / remaining)
            stalled = _any_hw(s.e > 0) & (
                ewma < torch.tensor(stall_threshold, dtype=torch.float32))
            if bool(stalled.any()):    # the reference's lax.cond
                h_bfs = bfs_relabel_heights(s.cap, s.cap_src, s.cap_sink,
                                            s.h, n_nodes, iters)
                s = s._replace(h=torch.where(stalled[..., None, None],
                                             h_bfs, s.h))
            return _count_heur(s, stalled)

        s = state
        for _ in range(rounds_per_heuristic):
            s = round_fn(s, n_nodes)
        s = s._replace(h=bfs_heights(s.cap, s.cap_sink, s.h, n_nodes, iters))
        return _count_heur(s, torch.ones(state.e.shape[:-2], dtype=torch.bool,
                                         device=state.e.device))

    def live(state: GridFlowState, rounds: torch.Tensor) -> torch.Tensor:
        return _any_hw(state.e > 0) & (rounds < max_rounds)

    def lead_axes(a, batch_ndim: int) -> int:
        # the only leaf with an axis before the batch axes is cap
        # (4, ..., H, W): the direction axis leads
        return 1 if a.dim() - batch_ndim == 3 else 0

    return LoopSpec(cycle=cycle, live=live,
                    rounds_per_cycle=rounds_per_heuristic,
                    lead_axes_fn=lead_axes,
                    heur=lambda s: s.heur)


def _grid_init(cap0, cs0, ct0, *, bfs_max_iters: int) -> GridFlowState:
    """Paper Alg. 4.7 init: saturate s->x, heights from a round-0 BFS.

    Internal layout: ``cs0``/``ct0`` ``(..., H, W)``, ``cap0``
    ``(4, ..., H, W)``, float32 on the solve's device.
    """
    *b, H, W = cs0.shape
    bshape = tuple(b)
    n_nodes = H * W + 2
    dev = cs0.device
    state = GridFlowState(
        e=cs0.clone(),
        h=torch.zeros(bshape + (H, W), dtype=torch.int32, device=dev),
        cap=cap0.contiguous(),
        cap_src=cs0.clone(),               # residual x -> s after saturation
        cap_sink=ct0.contiguous(),
        sink_flow=torch.zeros(bshape, dtype=torch.float32, device=dev),
        src_flow=torch.zeros(bshape, dtype=torch.float32, device=dev),
        heur=torch.zeros(bshape, dtype=torch.int32, device=dev),
    )
    # Start from BFS-consistent heights (global relabel at round 0).
    return state._replace(h=bfs_heights(state.cap, state.cap_sink, state.h,
                                        n_nodes, bfs_max_iters or n_nodes))


def _grid_finalize(state: GridFlowState, rounds, *,
                   bfs_max_iters: int) -> GridFlowResult:
    """Min cut + convergence flags from a finished (internal-layout) state.

    Sink side of the cut = nodes that still reach t in the residual graph.
    """
    H, W = state.e.shape[-2:]
    n_nodes = H * W + 2
    h_bfs = bfs_heights(state.cap, state.cap_sink, state.h, n_nodes,
                        bfs_max_iters or n_nodes)
    return GridFlowResult(
        flow=state.sink_flow,
        cut=h_bfs < n_nodes,
        state=state,
        rounds=rounds,
        converged=~_any_hw(state.e > 0),
        heuristics=state.heur,
    )


def _solve_grid(cap0, cs0, ct0, *, rounds_per_heuristic, max_rounds,
                bfs_max_iters, backend, stall_threshold=0.05,
                compact=False, lanes=None) -> GridFlowResult:
    """Shared solve, rank-polymorphic over leading batch axes.

    ``cs0``/``ct0`` are ``(..., H, W)`` with ``cap0`` ``(4, ..., H, W)``.
    ``compact`` (one batch axis): ``run_compacted`` gathers the still-live
    instances into dense pow2-sized sub-batches between cycles, so a
    converged instance stops costing device time instead of being
    select-masked until the whole batch drains; equal results. ``lanes``
    (compacted only): ``run_compacted``'s per-lane slices.
    """
    spec = _grid_spec(rounds_per_heuristic, max_rounds, bfs_max_iters,
                      backend, stall_threshold)
    state = _grid_init(cap0, cs0, ct0, bfs_max_iters=bfs_max_iters)
    if compact:
        state, rounds = run_compacted(spec, state, cs0.shape[0],
                                      lanes=lanes)
    else:
        state, rounds = run_masked(spec, state, tuple(cs0.shape[:-2]))
    return _grid_finalize(state, rounds, bfs_max_iters=bfs_max_iters)


def _grid_batch_impl(cap0, cs0, ct0, **kw) -> GridFlowResult:
    """``_solve_grid`` in the public batched layout (``cap0`` and the
    result's ``state.cap`` ``(B, 4, H, W)``): the per-lane function of the
    ``mesh=`` path, every leaf batch-leading."""
    res = _solve_grid(torch.movedim(cap0, 1, 0), cs0, ct0, **kw)
    return res._replace(state=res.state._replace(
        cap=torch.movedim(res.state.cap, 0, 1).contiguous()))


def _grid_warm(cap0, cs0, ct0, base_cap, base_ct, prior_cap, prior_ct,
               *, bfs_max_iters: int) -> GridFlowState:
    """Warm restart: clamp the prior flow to the new capacities, repair
    conservation deficits, re-BFS the heights (reference ``_grid_warm``).

    Internal layout throughout (``cap*`` ``(4, ..., H, W)``, the rest
    ``(..., H, W)``), float32 tensors on the solve's device. ``base_*``
    are the capacities the prior solve ran against; the prior NET flow per
    grid arc is ``base_cap - prior_cap`` and per sink edge ``base_ct -
    prior_ct``. The heights are exact BFS distances on the repaired
    residual graph from a zero ``h_prev`` (a uniform ``N`` on the
    unreachable region), so no residual edge violates them and K3 sees
    seeds and planes in [1, INF] only.

    Repair: clamping to shrunken capacities can leave nodes with negative
    excess. A Jacobi fixpoint loop lets every deficit node cut its own
    outgoing flow (sink edge first, then the grid directions) until
    conservation holds with ``e >= 0`` everywhere; flows only decrease, so
    it terminates. It is a host loop on the batch-wide predicate (one sync
    per iteration, at most ``4·H·W + 8`` iterations); an iteration on a
    repaired instance is a no-op. An instance still in deficit at the cap
    falls back to its cold init.
    """
    *b, H, W = cs0.shape
    n_nodes = H * W + 2
    bfs_iters = bfs_max_iters or n_nodes
    f32 = torch.float32
    capn, csn, ctn = cap0.to(f32), cs0.to(f32), ct0.to(f32)

    # prior positive flow per arc, clamped to the new capacities
    f = base_cap.to(f32) - prior_cap.to(f32)
    phi = torch.minimum(torch.clamp_min(f, 0.0), capn)
    fs = torch.minimum(torch.clamp_min(base_ct.to(f32) - prior_ct.to(f32),
                                       0.0), ctn)

    def excess(phi, fs):
        # source saturates (cold-init convention): inflow from s is csn
        inflow = sum(_move(phi[d], d) for d in range(4))
        return csn + inflow - phi.sum(0) - fs

    e, it = excess(phi, fs), 0
    while it < 4 * H * W + 8 and bool((e < 0).any()):
        deficit = torch.clamp_min(-e, 0.0)
        r = torch.minimum(deficit, fs)
        fs = fs - r
        deficit = deficit - r
        rows = []
        for d in range(4):
            r = torch.minimum(deficit, phi[d])
            rows.append(phi[d] - r)
            deficit = deficit - r
        phi = torch.stack(rows, 0)
        e, it = excess(phi, fs), it + 1

    resid = torch.stack(
        [capn[d] - phi[d] + _move(phi[_OPP[d]], _OPP[d]) for d in range(4)],
        0)
    cap_sink = ctn - fs
    dev = cs0.device
    warm = GridFlowState(
        e=torch.clamp_min(e, 0.0),
        h=bfs_heights(resid, cap_sink,
                      torch.zeros(csn.shape, dtype=torch.int32, device=dev),
                      n_nodes, bfs_iters),
        cap=resid,
        cap_src=csn.clone(),               # residual x -> s after saturation
        cap_sink=cap_sink,
        sink_flow=_gsum(fs),
        src_flow=torch.zeros(tuple(b), dtype=f32, device=dev),
        heur=torch.zeros(tuple(b), dtype=torch.int32, device=dev),
    )
    bad = _any_hw(e < 0)                   # per-instance repair failure
    if not bool(bad.any()):
        return warm
    cold = _grid_init(cap0, cs0, ct0, bfs_max_iters=bfs_max_iters)

    def pick(w, c):
        extra = w.dim() - bad.dim()        # trailing (H, W) / leading (4,)
        mask = bad
        if w.dim() - len(b) == 3:          # cap leaf: leading direction axis
            mask = bad[None]
            extra -= 1
        return torch.where(mask.reshape(tuple(mask.shape) + (1,) * extra),
                           c, w)

    return GridFlowState(*(pick(w, c) for w, c in zip(warm, cold)))


def _load(x, device: torch.device) -> torch.Tensor:
    """A float32 copy of a numpy array or tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32, copy=True)
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def maxflow_grid(
    problem: GridProblem,
    *,
    rounds_per_heuristic: int = 32,
    max_rounds: int = 100_000,
    bfs_max_iters: int = 0,
    backend: str = "xla",
    stall_threshold: float = 0.05,
    device=None,
) -> GridFlowResult:
    """Max-flow / min-cut of ONE grid-cut instance (paper §4).

    Args:
      problem: ``GridProblem`` with ``cap_nbr (4, H, W)``,
        ``cap_src``/``cap_sink`` ``(H, W)``, as numpy arrays or tensors.
        Integer-valued capacities keep every float32 sum exact.
      rounds_per_heuristic: Jacobi rounds between global-relabel passes.
      max_rounds: hard round cap; if hit, ``converged`` is False.
      bfs_max_iters: BFS sweep cap (0 = the H*W+2 upper bound).
      backend: ``"xla"`` (the paper's round as plain tensor ops),
        ``"multipush"`` (push to every lower neighbour per round),
        ``"pallas"`` (the decision on the K1 kernel) or ``"balanced"``
        (K2 over active tiles, stall-driven bidirectional relabel on K3).
        Unknown strings raise ``ValueError``.
      stall_threshold: ``"balanced"`` only; the relabel runs when the EWMA
        of terminal-retired flow per unit remaining excess drops below it.
      device: where to solve; ``None`` means ``"cuda"`` (raises without a
        card), ``"cpu"`` runs every kernel's plain version.

    Returns:
      ``GridFlowResult``: scalar ``flow`` (== min-cut value when
      ``converged``), ``cut (H, W)`` bool (True = sink side), the final
      ``GridFlowState``, scalar ``rounds``, ``converged`` and
      ``heuristics``.
    """
    cap0, cs0, ct0 = problem
    if cs0.ndim != 2 or cap0.ndim != 3:
        raise ValueError(
            f"maxflow_grid solves ONE instance (cap_nbr (4, H, W), got "
            f"{tuple(cap0.shape)}); use maxflow_grid_batch for stacked "
            f"problems")
    if not tuple(cap0.shape[1:]) == tuple(cs0.shape) == tuple(ct0.shape):
        raise ValueError(
            f"shapes do not match: cap_nbr {tuple(cap0.shape)}, cap_src "
            f"{tuple(cs0.shape)}, cap_sink {tuple(ct0.shape)}")
    _round_fn(backend)
    dev = resolve_device(device)
    return _solve_grid(_load(cap0, dev), _load(cs0, dev), _load(ct0, dev),
                       rounds_per_heuristic=rounds_per_heuristic,
                       max_rounds=max_rounds, bfs_max_iters=bfs_max_iters,
                       backend=backend, stall_threshold=stall_threshold)


def maxflow_grid_batch(
    problem: GridProblem,
    *,
    rounds_per_heuristic: int = 32,
    max_rounds: int = 100_000,
    bfs_max_iters: int = 0,
    backend: str = "xla",
    stall_threshold: float = 0.05,
    compact: bool = False,
    mesh=None,
    mesh_axis: str | None = None,
    device=None,
) -> GridFlowResult:
    """Max-flow on a BATCH of same-shape grid instances.

    Args:
      problem: ``GridProblem`` with a leading batch axis: ``cap_nbr``
        ``(B, 4, H, W)``, ``cap_src``/``cap_sink`` ``(B, H, W)``.
      rounds_per_heuristic / max_rounds / bfs_max_iters / backend /
        stall_threshold / device: as in ``maxflow_grid``, per instance.
      compact: early-exit compaction (``repro_torch.core.solver_loop``):
        between cycles the host gathers the still-live instances into a
        dense pow2-sized sub-batch, so a converged instance stops costing
        device time. Worth it when convergence is ragged; equal results.
      mesh: optional lane set (``repro_torch.launch.mesh.make_solver_mesh``):
        the batch splits into contiguous slices, one per lane, each solved
        on its lane's device with no communication; a batch that does not
        divide into the lanes is padded with zero (inert) instances,
        dropped from the result. With ``compact=True`` compaction stays
        within each lane (``compact_lanes``). Results come back on
        ``device`` and equal the solve without a mesh.
      mesh_axis: the lane set's axis (default: its first).

    Returns:
      ``GridFlowResult`` whose leaves lead with the batch axis:
      ``flow``/``rounds``/``converged``/``heuristics`` are ``(B,)``,
      ``cut`` is ``(B, H, W)`` and ``state.cap`` ``(B, 4, H, W)``.
      Per-instance liveness masks advance exactly the instances still
      running, so results equal a loop of single ``maxflow_grid`` solves.
    """
    cap0, cs0, ct0 = problem
    if cap0.ndim != 4 or cap0.shape[1] != 4 or cs0.ndim != 3:
        raise ValueError(
            f"maxflow_grid_batch expects cap_nbr (B, 4, H, W), got "
            f"{tuple(cap0.shape)}; use maxflow_grid for a single instance")
    if not (tuple(cs0.shape) == tuple(ct0.shape)
            == (cap0.shape[0],) + tuple(cap0.shape[2:])):
        raise ValueError(
            f"shapes do not match: cap_nbr {tuple(cap0.shape)}, cap_src "
            f"{tuple(cs0.shape)}, cap_sink {tuple(ct0.shape)}")
    _round_fn(backend)
    dev = resolve_device(device)
    args = (_load(cap0, dev), _load(cs0, dev), _load(ct0, dev))
    kw = dict(rounds_per_heuristic=rounds_per_heuristic,
              max_rounds=max_rounds, bfs_max_iters=bfs_max_iters,
              backend=backend, stall_threshold=stall_threshold)
    if mesh is not None:
        from repro_torch.launch.mesh import dispatch_sharded
        return dispatch_sharded(_grid_batch_impl, args, cs0.shape[0], mesh,
                                mesh_axis, compact=compact, **kw)
    # public layout: batch axis leads everywhere, including state.cap
    return _grid_batch_impl(*args, compact=compact, **kw)
