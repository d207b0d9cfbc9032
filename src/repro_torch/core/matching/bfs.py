"""Bipartite maximum-cardinality matching via lock-free BFS phases.

PyTorch port of ``repro/core/matching/bfs.py``, after the GPU
augmenting-path matching of Deveci, Kaya, Uçar & Çatalyürek
(arXiv:1303.1379). Column claims are a deterministic keyed minimum
(smallest root label, then smallest row index) instead of the paper's
atomics, so a phase is a pure function of the instance.

One heuristic cycle = one phase:

1. FOREST — fixpoint of frontier expansion: labeled rows reach columns
   over non-matching edges (K5, ``repro_torch.kernels.frontier``, under
   ``backend="pallas"``; a masked keyed-min reduction under ``"xla"``); a
   newly claimed column records its claiming row as parent and, if
   matched, labels its matched row with the same root.
2. AUGMENT — each root selects its minimum labeled free column as the one
   endpoint of its tree; the walks back along parent pointers are vertex-
   disjoint, so every path flips at once with collision-free scatters.
3. LIVENESS — ``progress`` records whether the phase augmented AND a free
   row with edges remains; a phase that finds no endpoint certifies
   maximality (Berge).

Every function is shape-polymorphic over leading batch axes and
per-instance pure. The reference's ``lax.while_loop``s (the greedy
fixpoint, the forest fixpoint and the walk) are host loops with the same
cond-before-body structure and one sync per iteration on the batch-wide
predicate; an iteration on an instance that has reached its fixpoint is
an exact no-op, so a batch equals a loop of single solves.

Entry points run on the card unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.solver_loop import LoopSpec, run_compacted, run_masked
from repro_torch.kernels.frontier.ops import frontier_op

INF = 2 ** 30
BACKENDS = ("xla", "pallas")
_I32 = torch.int32


class MatchingResult(NamedTuple):
    match_row: torch.Tensor    # (..., nl) int32: matched col per row, -1 free
    match_col: torch.Tensor    # (..., nr) int32: matched row per col, -1 free
    cardinality: torch.Tensor  # (...,) int32 matching size
    rounds: torch.Tensor       # (...,) int32 BFS phases run per instance
    converged: torch.Tensor    # (...,) bool: True = maximum certified (Berge)


class MatchState(NamedTuple):
    """Per-instance solver carry (all leaves lead with the batch axes)."""

    adj: torch.Tensor        # (..., nl, nr) bool adjacency (constant)
    match_row: torch.Tensor  # (..., nl) int32
    match_col: torch.Tensor  # (..., nr) int32
    progress: torch.Tensor   # (...,) bool: an augmenting path may still exist


def _has_free_work(adj, match_row):
    """A free row with at least one edge remains (every augmenting path
    starts at such a row)."""
    return ((match_row < 0) & adj.any(-1)).any(-1)


def _scatter_min(size: int, index, value, valid):
    """``out[..., j] = min(value[..., w] for w with valid and index == j)``,
    INF where none: the reference's dense masked keyed min as a scatter.
    Invalid entries go to a spare slot past the end, which is dropped."""
    lead = tuple(index.shape[:-1])
    out = torch.full(lead + (size + 1,), INF, dtype=_I32,
                     device=index.device)
    idx = torch.where(valid, index, size).long()
    out.scatter_reduce_(-1, idx, value.to(_I32), reduce="amin")
    return out[..., :size]


def _gather(a, idx):
    """``a[..., idx]`` along the last axis (``take_along_axis``)."""
    return torch.gather(a, -1, idx.long())


def _greedy_match(adj, match_row, match_col):
    """Deterministic maximal greedy matching (the phase-0 init of Deveci
    et al.): free rows propose their minimum free column; each column
    accepts its minimum proposer; repeat to fixpoint."""
    *_, nl, nr = adj.shape
    rows_i = torch.arange(nl, dtype=_I32, device=adj.device)
    cols_i = torch.arange(nr, dtype=_I32, device=adj.device)
    rows_b = rows_i.expand(match_row.shape)
    mr, mc, changed = match_row, match_col, True
    while changed:
        free = adj & (mr < 0).unsqueeze(-1) & (mc < 0).unsqueeze(-2)
        prop = torch.amin(torch.where(free, cols_i, INF), dim=-1)  # col | INF
        # each proposed column accepts its minimum proposing row
        acc = _scatter_min(nr, prop, rows_b, prop < INF)           # row | INF
        won = (prop < INF) & (_gather(acc, torch.clamp(prop, max=nr - 1))
                              == rows_i)
        mr = torch.where(won, prop, mr)
        mc = torch.where(acc < INF, acc, mc)
        changed = bool(won.any().item())
    return mr, mc


def _expand(adj, root_row, match_row, backend: str):
    """One frontier sweep: per column, (min root, claiming row) over labeled
    rows adjacent via non-matching edges — K5's contract."""
    if backend == "pallas":
        return frontier_op(adj, root_row, match_row)
    *_, nl, nr = adj.shape
    cols_i = torch.arange(nr, dtype=_I32, device=adj.device)
    rows_i = torch.arange(nl, dtype=_I32, device=adj.device)
    root = root_row.unsqueeze(-1)
    cand = torch.where(adj & (root < INF)
                       & (match_row.unsqueeze(-1) != cols_i), root, INF)
    min_root = torch.amin(cand, dim=-2)
    claim = torch.amin(torch.where(cand == min_root.unsqueeze(-2),
                                   rows_i.unsqueeze(-1), INF), dim=-2)
    return min_root, claim


def _phase(state: MatchState, backend: str) -> MatchState:
    """One lock-free BFS augmenting-path phase (the LoopSpec cycle)."""
    adj, match_row, match_col, _ = state
    *_, nl, nr = adj.shape
    dev = adj.device
    rows_i = torch.arange(nl, dtype=_I32, device=dev)
    cols_i = torch.arange(nr, dtype=_I32, device=dev)
    batch = tuple(match_row.shape[:-1])

    # ---- 1. alternating-BFS forest from every free row ------------------
    root_row = torch.where(match_row < 0, rows_i, INF)         # (..., nl)
    root_col = torch.full(batch + (nr,), INF, dtype=_I32, device=dev)
    parent = torch.zeros(batch + (nr,), dtype=_I32, device=dev)
    changed = True
    while changed:
        min_root, claim = _expand(adj, root_row, match_row, backend)
        newly = (root_col >= INF) & (min_root < INF)
        root_col = torch.where(newly, min_root, root_col)
        parent = torch.where(newly, claim, parent)
        # a labeled column's matched row inherits its root label
        rc = _gather(root_col, torch.clamp(match_row, min=0))  # (..., nl)
        row_new = (match_row >= 0) & (root_row >= INF) & (rc < INF)
        root_row = torch.where(row_new, rc, root_row)
        changed = bool((newly.any() | row_new.any()).item())

    # ---- 2. one endpoint per tree, then flip all paths at once ----------
    # endpoint[i] = min column j that is free, labeled, and has root i
    free_lab = (match_col < 0) & (root_col < INF)              # (..., nr)
    endpoint = _scatter_min(nl, root_col,
                            cols_i.expand(root_col.shape), free_lab)
    found = endpoint < INF
    cur = torch.where(found, endpoint, -1)

    mr, mc = match_row, match_col
    while bool((cur >= 0).any().item()):
        active = cur >= 0
        row = _gather(parent, torch.clamp(cur, min=0))
        prev = _gather(match_row, torch.clamp(row, min=0))
        # paths are vertex-disjoint: at most one walker writes each slot,
        # so a keyed-min scatter IS the scatter
        col_for_row = _scatter_min(nl, row, cur, active)
        mr = torch.where(col_for_row < INF, col_for_row, mr)
        row_for_col = _scatter_min(nr, cur, row, active)
        mc = torch.where(row_for_col < INF, row_for_col, mc)
        # step back over the matched edge; a free (root) row ends the walk
        cur = torch.where(active, prev, cur)

    # ---- 3. liveness: augmented AND something left to try ---------------
    progress = found.any(-1) & _has_free_work(adj, mr)
    return MatchState(adj=adj, match_row=mr, match_col=mc, progress=progress)


@functools.lru_cache(maxsize=None)
def _matching_spec(max_rounds: int, backend: str) -> LoopSpec:
    """The matching solver's registration with the solver-loop runtime:
    one cycle = one BFS augmenting-path phase (cached per knob pair)."""

    def cycle(state: MatchState) -> MatchState:
        return _phase(state, backend)

    def live(state: MatchState, rounds: torch.Tensor) -> torch.Tensor:
        return state.progress & (rounds < max_rounds)

    return LoopSpec(cycle=cycle, live=live, rounds_per_cycle=1,
                    lead_axes_fn=None)


def _match_init(adj, *, greedy_init: bool) -> MatchState:
    """Initial state: optional maximal greedy matching, then the liveness
    seed — a phase can only help while a free row with edges exists."""
    *batch, nl, nr = adj.shape
    mr = torch.full(tuple(batch) + (nl,), -1, dtype=_I32, device=adj.device)
    mc = torch.full(tuple(batch) + (nr,), -1, dtype=_I32, device=adj.device)
    if greedy_init:
        mr, mc = _greedy_match(adj, mr, mc)
    return MatchState(adj=adj, match_row=mr, match_col=mc,
                      progress=_has_free_work(adj, mr))


def _match_warm(adj, mr_prior, *, greedy_init: bool) -> MatchState:
    """Warm state: keep the prior matched pairs that survive the new
    adjacency; the unchanged augmenting phases restore maximality
    (reference ``_match_warm``).

    Any valid matching is a sound starting forest (Berge), and maximum
    cardinality is unique, so a warm solve lands on the cold optimum. A
    pair survives only if its edge still exists; the column side is
    rebuilt from the row side (ties keep the minimum row, a keyed
    ``amin`` scatter in place of the reference's dense masked min) and
    rows that lost the tie are scrubbed, so even a stale or foreign seed
    degrades to a smaller but valid matching. ``greedy_init`` extends the
    seed with the greedy pass (it only pairs free rows with free columns).
    """
    *_, nl, nr = adj.shape
    rows_i = torch.arange(nl, dtype=_I32, device=adj.device)
    mr = mr_prior.to(_I32)
    in_range = (mr >= 0) & (mr < nr)
    edge = _gather(adj, torch.clamp(mr, 0, nr - 1).unsqueeze(-1)) \
        .squeeze(-1)
    mr = torch.where(in_range & edge, mr, -1)
    # column side from the row side: the minimum row claiming each column
    mc = _scatter_min(nr, mr, rows_i.expand_as(mr), mr >= 0)
    mc = torch.where(mc < INF, mc, -1)
    back = _gather(mc, torch.clamp_min(mr, 0))
    mr = torch.where((mr >= 0) & (back == rows_i), mr, -1)
    if greedy_init:
        mr, mc = _greedy_match(adj, mr, mc)
    return MatchState(adj=adj, match_row=mr, match_col=mc,
                      progress=_has_free_work(adj, mr))


def _match_finalize(state: MatchState, rounds) -> MatchingResult:
    """Result view: ``converged`` is the Berge certificate — the last phase
    found no augmenting path (False only when ``max_rounds`` was hit)."""
    return MatchingResult(
        match_row=state.match_row, match_col=state.match_col,
        cardinality=(state.match_row >= 0).sum(-1, dtype=_I32),
        rounds=rounds, converged=~state.progress)


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; valid: "
                         f"{', '.join(BACKENDS)}")


def _solve_match(adj, *, max_rounds, greedy_init, backend,
                 compact=False, lanes=None) -> MatchingResult:
    """Shared solver loop, rank-polymorphic over leading batch axes;
    ``compact`` (one batch axis): early-exit compaction, an instance whose
    maximality is certified leaves the working set between phases, within
    ``run_compacted``'s ``lanes``."""
    _check_backend(backend)
    state = _match_init(adj, greedy_init=greedy_init)
    spec = _matching_spec(max_rounds, backend)
    if compact:
        state, rounds = run_compacted(spec, state, adj.shape[0],
                                      lanes=lanes)
    else:
        state, rounds = run_masked(spec, state, tuple(adj.shape[:-2]))
    return _match_finalize(state, rounds)


def _load_adj(adj, device: torch.device) -> torch.Tensor:
    """A bool copy of an adjacency (numpy array or tensor) on ``device``."""
    if isinstance(adj, torch.Tensor):
        return adj.to(device=device, dtype=torch.bool, copy=True)
    return torch.tensor(np.asarray(adj, dtype=bool), device=device)


def match_bipartite(
    adj,
    *,
    max_rounds: int = 10_000,
    greedy_init: bool = True,
    backend: str = "xla",
    device=None,
) -> MatchingResult:
    """Maximum-cardinality matching of ONE bipartite instance.

    Args:
      adj: ``(nl, nr)`` bool adjacency (numpy array or tensor) —
        ``adj[i, j]`` iff left vertex ``i`` is adjacent to right vertex
        ``j`` (rectangular fine).
      max_rounds: BFS-phase cap (at most ``min(nl, nr)`` phases are ever
        needed).
      greedy_init: start from a deterministic maximal greedy matching
        (fewer phases; identical final cardinality either way).
      backend: ``"xla"`` (plain tensor code) or ``"pallas"`` (the
        frontier-expansion sweep on K5) — equal results.
      device: where to solve; ``None`` means ``"cuda"`` (raises without a
        card), ``"cpu"`` runs K5's plain version.

    Returns:
      ``MatchingResult``: ``match_row (nl,)`` / ``match_col (nr,)`` with
      ``-1`` marking unmatched vertices, the ``cardinality`` (equal to
      Hopcroft–Karp's, ``repro_torch.core.matching.ref``), ``rounds``
      (phases run) and ``converged``.
    """
    if adj.ndim != 2:
        raise ValueError(
            f"match_bipartite solves ONE instance (adj (nl, nr), got "
            f"{tuple(adj.shape)}); use match_bipartite_batch for stacked "
            f"problems")
    return _solve_match(_load_adj(adj, resolve_device(device)),
                        max_rounds=max_rounds, greedy_init=greedy_init,
                        backend=backend)


def match_bipartite_batch(
    adj,
    *,
    max_rounds: int = 10_000,
    greedy_init: bool = True,
    backend: str = "xla",
    compact: bool = False,
    mesh=None,
    mesh_axis: str | None = None,
    device=None,
) -> MatchingResult:
    """Matching on a BATCH of same-shape bipartite instances.

    Args:
      adj: ``(B, nl, nr)`` bool — a stack of single-instance adjacencies.
      max_rounds / greedy_init / backend / device: as in
        ``match_bipartite`` (applied per instance).
      compact: early-exit compaction (``repro_torch.core.solver_loop``):
        an instance whose maximality is certified leaves the working set
        between phases; equal results.
      mesh / mesh_axis: optional lane set
        (``repro_torch.launch.mesh.make_solver_mesh``): each lane solves a
        contiguous slice of the batch on its device, padded with edgeless
        (inert) instances where the batch does not divide; with
        ``compact=True`` compaction stays within each lane. Equal results,
        returned on ``device``.

    Returns ``MatchingResult`` with every leaf leading with the batch axis;
    it equals a loop of single solves leaf for leaf.
    """
    if adj.ndim != 3:
        raise ValueError(
            f"match_bipartite_batch expects adj (B, nl, nr), got "
            f"{tuple(adj.shape)}; use match_bipartite for a single instance")
    kw = dict(max_rounds=max_rounds, greedy_init=greedy_init,
              backend=backend)
    a = _load_adj(adj, resolve_device(device))
    if mesh is None:
        return _solve_match(a, compact=compact, **kw)
    from repro_torch.launch.mesh import dispatch_sharded
    return dispatch_sharded(_solve_match, (a,), adj.shape[0], mesh,
                            mesh_axis, compact=compact, **kw)
