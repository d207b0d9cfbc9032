"""Bipartite maximum-cardinality matching: the registry's third kind.

Counterpart of ``repro/core/matching/__init__.py``. It re-exports the
solver (``repro_torch.core.matching.bfs``, lock-free BFS augmenting-path
phases after Deveci et al., arXiv:1303.1379) and the Hopcroft–Karp
oracle, and REGISTERS the ``"matching"`` kind: the validate, pad, inert
and bucket stages, the device stage ``solve_prepared_matching``, and the
loop-spec and refill factories and the warm-start hooks, so the ragged
front end (``repro_torch.core.batch.solve_batch``), early-exit
compaction, refill sessions and warm starts serve matching with no change
to those layers.

This package has a real ``__init__`` on purpose: importing
``repro_torch.core.matching`` is what registers the kind, and the
registry's lazy builtin import relies on that side effect.

Payload forms accepted by the validator (both canonicalize to a dense
``(nl, nr)`` bool numpy adjacency):

  * a dense 2-D bool or 0/1 array: ``adj[i, j]`` iff left ``i`` ~ right
    ``j``;
  * an ``(edges, (nl, nr))`` tuple, ``edges`` an ``(E, 2)`` integer array
    of ``(left, right)`` endpoint ids.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.batch import (BucketStats, PreparedBucket,
                                    _make_buckets, _stats)
from repro_torch.core.kinds import SolverKind, register_kind
from repro_torch.core.matching.bfs import (MatchingResult, _matching_spec,
                                           match_bipartite,
                                           match_bipartite_batch)
from repro_torch.core.matching.ref import hopcroft_karp
from repro_torch.core.refill import RefillRuntime

__all__ = [
    "MatchingResult", "match_bipartite", "match_bipartite_batch",
    "hopcroft_karp", "validate_matching_problem", "pad_matching_problem",
    "inert_matching_problem", "prepare_matching_buckets",
    "solve_prepared_matching",
]


def validate_matching_problem(payload) -> np.ndarray:
    """Canonicalize + validate a matching request (the kind's validator).

    Same reject-before-ticket contract as the other kinds: malformed
    requests raise ``ValueError`` before any queue entry or future exists.
    Accepts a dense bool / 0-1 adjacency or an ``(edges, (nl, nr))``
    tuple; returns the dense ``(nl, nr)`` bool adjacency.
    """
    if (isinstance(payload, tuple) and len(payload) == 2
            and isinstance(payload[1], (tuple, list))
            and len(payload[1]) == 2
            and np.asarray(payload[0]).ndim == 2
            and np.asarray(payload[0]).shape[-1] == 2):
        edges = np.asarray(payload[0])
        nl, nr = (int(s) for s in payload[1])
        if nl < 1 or nr < 1:
            raise ValueError(
                f"malformed matching problem: empty side in shape "
                f"({nl}, {nr})")
        if not np.issubdtype(edges.dtype, np.integer):
            raise ValueError(
                f"malformed matching problem: edge list must hold integer "
                f"vertex ids, got dtype {edges.dtype}")
        if edges.size and edges.min() < 0:
            raise ValueError(
                f"malformed matching problem: negative vertex id "
                f"{int(edges.min())} in edge list")
        if edges.size and (edges[:, 0].max() >= nl
                           or edges[:, 1].max() >= nr):
            raise ValueError(
                f"malformed matching problem: edge endpoint out of range "
                f"for shape ({nl}, {nr})")
        adj = np.zeros((nl, nr), bool)
        adj[edges[:, 0], edges[:, 1]] = True
        return adj
    try:
        a = np.asarray(payload)
    except (TypeError, ValueError) as e:
        raise ValueError(f"malformed matching problem: not array-like ({e})")
    if a.ndim != 2 or a.dtype == object:
        raise ValueError(
            f"malformed matching problem: need a 2-D (nl, nr) adjacency "
            f"or an (edges, (nl, nr)) tuple, got shape {a.shape} dtype "
            f"{a.dtype}")
    if a.shape[0] < 1 or a.shape[1] < 1:
        raise ValueError(
            f"malformed matching problem: empty side in shape {a.shape}")
    if a.dtype != bool:
        if not (np.issubdtype(a.dtype, np.integer)
                or np.issubdtype(a.dtype, np.floating)):
            raise ValueError(
                f"malformed matching problem: non-numeric adjacency dtype "
                f"{a.dtype}")
        if not np.isin(np.asarray(a), (0, 1)).all():
            raise ValueError(
                "malformed matching problem: adjacency entries must be "
                "0/1 (not a bipartite adjacency matrix)")
    return a.astype(bool)


def pad_matching_problem(adj, NL: int, NR: int) -> np.ndarray:
    """Pad an adjacency with edge-less vertices to (NL, NR) —
    value-preserving: isolated vertices join no matching."""
    adj = np.asarray(adj, bool)
    nl, nr = adj.shape
    assert NL >= nl and NR >= nr, (NL, NR, nl, nr)
    return np.pad(adj, ((0, NL - nl), (0, NR - nr)))


def inert_matching_problem(nl: int, nr: int) -> np.ndarray:
    """An edge-less instance: zero liveness seed, converges in 0 rounds —
    the matching kind's shard-padding filler."""
    return np.zeros((nl, nr), bool)


def prepare_matching_buckets(
    payloads: Iterable,
    *,
    bucket: str = "max",
    mesh=None,
    mesh_axis: str | None = None,
) -> list[PreparedBucket]:
    """HOST stage of the ``"matching"`` kind: bucket, pad, and stack
    (numpy). Payloads run through ``validate_matching_problem``, so both
    the dense and the ``(edges, (nl, nr))`` edge-list forms work here."""
    adjs = [validate_matching_problem(p) for p in payloads]
    shapes = [a.shape for a in adjs]

    def build(bshape, idxs, n_pad):
        NL, NR = bshape
        mats = [pad_matching_problem(adjs[i], NL, NR) for i in idxs]
        mats += [inert_matching_problem(NL, NR)] * n_pad
        return np.stack(mats), None

    return _make_buckets("matching", shapes, bucket=bucket, mesh=mesh,
                         mesh_axis=mesh_axis, build=build)


def _crop_matching(res: MatchingResult, b: int, nl: int,
                   nr: int) -> MatchingResult:
    """Instance ``b`` of a batched result, cropped to its original
    (nl, nr): padded vertices are isolated, so the crop drops only
    ``-1``s and the cardinality is unchanged."""
    return MatchingResult(
        match_row=res.match_row[b, :nl],
        match_col=res.match_col[b, :nr],
        cardinality=res.cardinality[b],
        rounds=res.rounds[b],
        converged=res.converged[b],
    )


def solve_prepared_matching(
    prep: PreparedBucket,
    *,
    compact: bool = False,
    mesh=None,
    mesh_axis: str | None = None,
    **solver_kw,
) -> tuple[dict[int, MatchingResult], BucketStats]:
    """DEVICE stage of the ``"matching"`` kind: one batched solve.

    Returns ``({request_position: result}, BucketStats)``, each result
    cropped back to the request's original (nl, nr).
    """
    res = match_bipartite_batch(prep.stacked, compact=compact, mesh=mesh,
                                mesh_axis=mesh_axis, **solver_kw)
    out = {i: _crop_matching(res, b, *prep.shapes[b])
           for b, i in enumerate(prep.idxs)}
    return out, _stats("matching", prep, res.rounds, res.converged, compact)


def _matching_inert(shape: tuple) -> np.ndarray:
    return inert_matching_problem(*shape)


def _matching_loop_spec(*, max_rounds: int = 10_000, backend: str = "xla"):
    """The matching solver's cached ``LoopSpec`` factory
    (``match_bipartite`` defaults); see ``repro_torch.core.matching.bfs``."""
    return _matching_spec(max_rounds, backend)


def _matching_refill(*, max_rounds: int = 10_000, greedy_init: bool = True,
                     backend: str = "xla", device=None) -> RefillRuntime:
    """The ``"matching"`` kind's continuous-batching runtime: isolated-
    vertex padding in, match-vector crop out; the same spec, init and
    finalize as the compacted batch solve, so a refilled instance equals
    its closed-batch solve."""
    from repro_torch.core.matching.bfs import (_check_backend, _load_adj,
                                               _match_finalize, _match_init)
    _check_backend(backend)
    spec = _matching_spec(max_rounds, backend)
    dev = resolve_device(device)

    def pad_one(adj, shape):
        NL, NR = shape
        return pad_matching_problem(adj, NL, NR)[None]

    def init(stacked):
        return _match_init(_load_adj(stacked, dev), greedy_init=greedy_init)

    def finalize(stacked, state, rounds) -> MatchingResult:
        return _match_finalize(state, rounds)

    def crop(res: MatchingResult, shape, original) -> MatchingResult:
        return _crop_matching(res, 0, *shape)

    def shape_of(adj) -> tuple:
        return tuple(adj.shape)

    return RefillRuntime(spec=spec, pad_one=pad_one, init=init,
                         finalize=finalize, crop=crop, shape_of=shape_of)


def _matching_init_state(**solver_kw):
    """Cold per-instance init: the refill runtime's init, registered on
    the warm seam so mixed warm/cold batches share one code path."""
    return _matching_refill(**solver_kw).init


def _matching_warm_state(*, max_rounds: int = 10_000,
                         greedy_init: bool = True, backend: str = "xla",
                         device=None):
    """Warm per-instance init: seed the state with the prior matched pairs
    that survive the mutated adjacency and let the augmenting phases
    restore maximality (``repro_torch.core.matching.bfs._match_warm``)."""
    from repro_torch.core.batch import _pad_trailing
    from repro_torch.core.matching.bfs import _load_adj, _match_warm
    dev = resolve_device(device)

    def warm1(stacked1, solution, *, base_problem1=None, delta_bound=None):
        adj = _load_adj(stacked1, dev)
        mr = _pad_trailing(solution["match_row"], (adj.shape[-2],),
                           fill=-1).to(device=dev, dtype=torch.int32)[None]
        return _match_warm(adj, mr, greedy_init=greedy_init)

    return warm1


def _matching_solution_of(res: MatchingResult):
    """Cacheable artifact: the matched forest's row side (the column side
    is rebuilt from it at warm time)."""
    return {"match_row": res.match_row}


register_kind(SolverKind(
    name="matching",
    validate=validate_matching_problem,
    inert_problem=_matching_inert,
    prepare_buckets=prepare_matching_buckets,
    solve_prepared=solve_prepared_matching,
    loop_spec=_matching_loop_spec,
    refill=_matching_refill,
    init_state=_matching_init_state,
    warm_state=_matching_warm_state,
    solution_of=_matching_solution_of,
))
