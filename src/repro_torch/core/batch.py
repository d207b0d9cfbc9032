"""Batched multi-instance solver engine: pad-and-bucket front end.

Counterpart of ``repro/core/batch.py``. ``solve_batch(kind, payloads)``
takes a ragged collection of problems of one registered solver kind
(``repro_torch.core.kinds``), pads each to a bucket shape (value-
preserving, see the per-kind pad helpers), stacks every bucket into one
leading batch axis, and runs ONE batched solve per bucket. The per-kind
entry points ``solve_maxflow_batch`` / ``solve_assignment_batch`` are thin
wrappers over the same generic path.

Per-instance convergence inside a batch is handled by the solvers'
liveness masks (or, with ``compact=True``, by early-exit compaction), so
batched results equal a loop of single-instance solves of the same padded
problems.

Bucketing contract (``bucket=``):
  * ``"max"``: every instance pads to the global max shape: one solve.
  * ``"pow2"``: shapes round up to powers of two: a few solves, bounded
    padding waste (< 4x area for grids, < 2x for matrices).
  * ``"exact"``: no padding: one solve per distinct shape.
Results are always returned in input order, cropped back to original sizes.

Two-stage split: each front end is a HOST stage, ``prepare_buckets``
(bucketing, padding, stacking, all numpy), and a DEVICE stage,
``solve_prepared`` (the stacked problem goes to the solve's device once,
one batched solve, then cropping), which also returns a ``BucketStats``
record (occupancy, per-instance round spread, convergence counts).

Lanes (``mesh=``): pass a lane set
(``repro_torch.launch.mesh.make_solver_mesh``) and each bucket's batch
splits into contiguous slices, one per lane, each solved on its lane's
device. Buckets whose size is not a multiple of the lane count are padded
with INERT instances (each kind's ``inert_problem``), dropped before
returning; results equal the solve without lanes.

Warm starts (``warm=``): ``{payload_position: WarmStart}`` routes the
queue through ``repro_torch.core.warm.solve_warm``, which mixes warm and
cold instances in the same buckets.

This module REGISTERS the paper's two kinds (``"maxflow"`` and
``"assignment"``) with the registry at the bottom of the file, warm-start
hooks included; the third, ``"matching"``, registers itself in
``repro_torch.core.matching``.

``device=`` travels with the other solver knobs (``**solver_kw``) to the
solvers and the refill runtimes; it defaults to the card.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.assignment.cost_scaling import (AssignmentResult,
                                                      solve_assignment)
from repro_torch.core.kinds import SolverKind, get_kind, register_kind
from repro_torch.core.maxflow.grid import (GridFlowResult, GridProblem,
                                           maxflow_grid_batch)
from repro_torch.core.refill import RefillRuntime

__all__ = [
    "pad_grid_problem", "stack_grid_problems", "pad_cost_matrix",
    "inert_grid_problem", "inert_cost_matrix", "solve_maxflow_batch",
    "solve_assignment_batch", "PreparedBucket", "BucketStats",
    "prepare_buckets", "solve_prepared", "solve_batch",
    "prepare_maxflow_buckets", "solve_prepared_maxflow",
    "prepare_assignment_buckets", "solve_prepared_assignment",
    "validate_grid_problem", "validate_assignment_matrix",
]


def _pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length() if x > 1 else 1


def _bucket_shape(shape: tuple, mode: str, max_shape: tuple) -> tuple:
    if mode == "max":
        return max_shape
    if mode == "pow2":
        return tuple(_pow2(s) for s in shape)
    if mode == "exact":
        return shape
    raise ValueError(f"unknown bucket mode: {mode!r}")


def _shard_pad(n_real: int, mesh, mesh_axis) -> int:
    """Inert instances to append so the bucket splits evenly across the
    lanes of ``mesh``."""
    if mesh is None:
        return 0
    from repro_torch.launch.mesh import shard_count
    return -n_real % shard_count(mesh, mesh_axis)


def _host(a) -> np.ndarray:
    """A numpy view or copy of a numpy array, tensor or array-like."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class PreparedBucket(NamedTuple):
    """One bucket's host-stage output: padded, stacked, dispatch-ready.

    ``kind`` names the registered solver kind whose ``solve_prepared``
    consumes this bucket. ``idxs`` are positions in the original request
    sequence (results are keyed by them); ``shapes`` are the requests'
    original shapes for cropping; ``stacked`` is the batch-leading stacked
    problem (numpy leaves); ``originals`` holds raw per-request payloads
    when a kind's device stage needs unpadded values (the assignment kind
    recomputes weights on them) and is ``None`` otherwise. ``n_pad``
    counts trailing inert instances appended so the batch divides into
    the lanes: the stacked batch is ``len(idxs) + n_pad`` instances,
    reals first.
    """

    kind: str                    # a registered solver kind name
    shape: tuple                 # bucket shape, e.g. (H, W) / (m,) / (nl, nr)
    idxs: tuple[int, ...]        # request positions, in submission order
    shapes: tuple                # original per-request shapes
    stacked: Any                 # batch-leading stacked problem (numpy)
    originals: tuple | None      # raw payloads, when the kind needs them
    n_pad: int                   # trailing inert shard-padding instances


class BucketStats(NamedTuple):
    """What one batched solve observed.

    ``spread`` is the normalized per-instance round raggedness
    ``(rounds_max - rounds_min) / max(rounds_max, 1)`` over REAL instances:
    about 0 when the whole bucket converges together (masked solving is
    enough), toward 1 when stragglers dominate (early-exit compaction
    pays). ``heur_min``/``heur_max``/``heur_mean`` summarize per-instance
    global-relabel invocations for kinds that report them (``"maxflow"``);
    ``None`` for kinds that don't.
    """

    kind: str
    shape: tuple
    n_real: int
    n_pad: int
    compact: bool
    rounds_min: int
    rounds_max: int
    rounds_mean: float
    n_converged: int
    heur_min: int | None = None
    heur_max: int | None = None
    heur_mean: float | None = None

    @property
    def spread(self) -> float:
        return (self.rounds_max - self.rounds_min) / max(self.rounds_max, 1)


def _stats(kind: str, prep: PreparedBucket, rounds, converged,
           compact: bool, heuristics=None) -> BucketStats:
    r = _host(rounds)[:len(prep.idxs)]          # real instances only
    c = _host(converged)[:len(prep.idxs)]
    heur: dict = {}
    if heuristics is not None:
        hh = _host(heuristics)[:len(prep.idxs)]
        heur = dict(heur_min=int(hh.min()), heur_max=int(hh.max()),
                    heur_mean=float(hh.mean()))
    return BucketStats(
        kind=kind, shape=prep.shape, n_real=len(prep.idxs),
        n_pad=prep.n_pad, compact=compact,
        rounds_min=int(r.min()), rounds_max=int(r.max()),
        rounds_mean=float(r.mean()), n_converged=int(c.sum()), **heur)


def _make_buckets(kind: str, shapes: Sequence[tuple], *, bucket: str,
                  mesh, mesh_axis,
                  build: Callable) -> list[PreparedBucket]:
    """The shared host-stage loop every kind's ``prepare_buckets`` drives.

    Groups request positions by bucket shape (per-axis max under
    ``"max"``, per-axis pow2 under ``"pow2"``, identity under
    ``"exact"``), computes the inert padding, and calls
    ``build(bucket_shape, idxs, n_pad) -> (stacked, originals)`` for the
    kind-specific pad/stack work.
    """
    if not shapes:
        return []
    ndim = len(shapes[0])
    max_shape = tuple(max(s[d] for s in shapes) for d in range(ndim))
    groups: dict[tuple, list[int]] = {}
    for i, s in enumerate(shapes):
        groups.setdefault(_bucket_shape(s, bucket, max_shape), []).append(i)
    out = []
    for bshape, idxs in groups.items():
        n_pad = _shard_pad(len(idxs), mesh, mesh_axis)
        stacked, originals = build(bshape, idxs, n_pad)
        out.append(PreparedBucket(
            kind=kind, shape=bshape, idxs=tuple(idxs),
            shapes=tuple(shapes[i] for i in idxs), stacked=stacked,
            originals=originals, n_pad=n_pad))
    return out


# ------------------------------------------------- generic (registry) API

def prepare_buckets(kind: str, payloads: Sequence, *, bucket: str = "max",
                    mesh=None,
                    mesh_axis: str | None = None) -> list[PreparedBucket]:
    """HOST stage for any registered kind: bucket, pad, and stack a ragged
    queue of ``kind`` payloads (unknown kinds raise ``ValueError`` naming
    the registered ones)."""
    return get_kind(kind).prepare_buckets(payloads, bucket=bucket,
                                          mesh=mesh, mesh_axis=mesh_axis)


def solve_prepared(prep: PreparedBucket, *, compact: bool = False,
                   mesh=None, mesh_axis: str | None = None,
                   **solver_kw) -> tuple[dict[int, Any], BucketStats]:
    """DEVICE stage for any registered kind: one batched solve of a
    prepared bucket, routed through ``prep.kind``'s registration. Returns
    ``({payload_position: result}, BucketStats)``."""
    return get_kind(prep.kind).solve_prepared(
        prep, compact=compact, mesh=mesh, mesh_axis=mesh_axis, **solver_kw)


def solve_batch(
    kind: str,
    payloads: Iterable,
    *,
    bucket: str = "max",
    compact: bool = False,
    mesh=None,
    mesh_axis: str | None = None,
    stats_out: list | None = None,
    warm: dict | None = None,
    **solver_kw,
) -> list:
    """Solve many (possibly ragged) instances of one registered kind.

    ``prepare_buckets`` + ``solve_prepared`` back to back, one batched
    solve per bucket, results in input order cropped back to original
    shapes.

    Args:
      kind: a registered solver kind name (``registered_kinds()``);
        unknown kinds raise ``ValueError`` naming the registered ones.
      payloads: the kind's problem instances (any mix of shapes).
      bucket: ``"max"`` | ``"pow2"`` | ``"exact"`` (module docstring).
      compact: early-exit compaction per bucket (equal results).
      mesh / mesh_axis: optional lane set: each bucket's batch splits
        across it, padded with the kind's inert instances so every bucket
        divides (dropped before returning).
      stats_out: optional list; one ``BucketStats`` per bucket is
        appended.
      warm: optional ``{payload_position: WarmStart}``: those instances
        start from their cached prior solutions through the kind's
        ``warm_state`` hook, in the same buckets as the cold ones
        (``repro_torch.core.warm.solve_warm`` drives the solve).
      **solver_kw: forwarded to the kind's solver (``backend=``,
        ``max_rounds=``, ``device=``, ...).
    """
    payloads = list(payloads)
    k = get_kind(kind)
    if not payloads:
        return []
    if warm:
        from repro_torch.core.warm import solve_warm
        return solve_warm(kind, payloads, warm, bucket=bucket,
                          compact=compact, mesh=mesh, mesh_axis=mesh_axis,
                          stats_out=stats_out, **solver_kw)
    results: list = [None] * len(payloads)
    for prep in k.prepare_buckets(payloads, bucket=bucket, mesh=mesh,
                                  mesh_axis=mesh_axis):
        out, stats = k.solve_prepared(prep, compact=compact, mesh=mesh,
                                      mesh_axis=mesh_axis, **solver_kw)
        if stats_out is not None:
            stats_out.append(stats)
        for i, r in out.items():
            results[i] = r
    return results


# ---------------------------------------------------------------- max-flow

def validate_grid_problem(problem) -> GridProblem:
    """Canonicalize + validate a max-flow request (shapes, dtypes, values).

    The ``"maxflow"`` kind's registered validator: malformed requests are
    rejected before they are queued. Checks shape ((4, H, W) / (H, W) /
    (H, W)), numeric dtype (bool and object arrays are refused), and
    values: capacities must be finite and non-negative. Returns a
    ``GridProblem`` of numpy arrays.
    """
    try:
        cap, cs, ct = (_host(a) for a in problem)
    except (TypeError, ValueError) as e:
        raise ValueError(f"malformed grid problem: not array-like ({e})")
    if cap.ndim != 3 or cap.shape[0] != 4 or cs.shape != ct.shape \
            or cs.shape != cap.shape[1:]:
        raise ValueError(
            f"malformed grid problem: cap_nbr {cap.shape}, "
            f"cap_src {cs.shape}, cap_sink {ct.shape}; expected "
            f"(4, H, W) / (H, W) / (H, W)")
    for name, a in (("cap_nbr", cap), ("cap_src", cs), ("cap_sink", ct)):
        if not (np.issubdtype(a.dtype, np.floating)
                or np.issubdtype(a.dtype, np.integer)):
            raise ValueError(
                f"malformed grid problem: {name} has non-numeric dtype "
                f"{a.dtype} (need integer or floating capacities)")
        if not np.all(np.isfinite(a)):
            raise ValueError(
                f"malformed grid problem: {name} contains non-finite "
                f"capacities (NaN/inf)")
        if np.any(a < 0):
            raise ValueError(
                f"malformed grid problem: {name} contains negative "
                f"capacities (min={a.min()})")
    return GridProblem(cap, cs, ct)


def pad_grid_problem(problem: GridProblem, H: int, W: int) -> GridProblem:
    """Zero-capacity pad a grid-cut instance to (H, W) (numpy).

    Padded nodes carry no terminal or neighbour capacity, so they hold no
    excess and never push or relabel usefully: the max-flow value (and the
    cut restricted to the original window) of the padded instance equals
    the original's.
    """
    cap, cs, ct = (_host(a) for a in problem)
    h, w = cs.shape[-2:]
    assert H >= h and W >= w, (H, W, h, w)
    pad2 = ((0, H - h), (0, W - w))
    return GridProblem(
        cap_nbr=np.pad(cap, ((0, 0),) + pad2),
        cap_src=np.pad(cs, pad2),
        cap_sink=np.pad(ct, pad2),
    )


def stack_grid_problems(problems: Sequence[GridProblem]) -> GridProblem:
    """Stack same-shape instances into the (B, 4, H, W) batched layout."""
    return GridProblem(*(np.stack([_host(p[k]) for p in problems])
                         for k in range(3)))


def inert_grid_problem(H: int, W: int) -> GridProblem:
    """An all-zero-capacity instance: no excess, converges in 0 rounds.

    Fills a refill session's empty slots (and, with device lanes, pads a
    bucket to the lane count): inert instances never push, relabel, or
    affect their batch-mates.
    """
    return GridProblem(
        cap_nbr=np.zeros((4, H, W), np.float32),
        cap_src=np.zeros((H, W), np.float32),
        cap_sink=np.zeros((H, W), np.float32),
    )


def prepare_maxflow_buckets(
    problems: Iterable[GridProblem],
    *,
    bucket: str = "max",
    mesh=None,
    mesh_axis: str | None = None,
) -> list[PreparedBucket]:
    """HOST stage of the ``"maxflow"`` kind: bucket, pad, and stack
    (numpy, no device work). One ``PreparedBucket`` per bucket shape."""
    problems = [GridProblem(*(_host(a) for a in p)) for p in problems]
    shapes = [tuple(p.cap_src.shape) for p in problems]

    def build(bshape, idxs, n_pad):
        H, W = bshape
        padded = [pad_grid_problem(problems[i], H, W) for i in idxs]
        padded += [inert_grid_problem(H, W)] * n_pad
        return stack_grid_problems(padded), None

    return _make_buckets("maxflow", shapes, bucket=bucket, mesh=mesh,
                         mesh_axis=mesh_axis, build=build)


def _crop_grid(res: GridFlowResult, b: int, h: int, w: int) \
        -> GridFlowResult:
    """Instance ``b`` of a batched (public layout) result, cropped to its
    original (h, w)."""
    st = res.state
    return GridFlowResult(
        flow=res.flow[b],
        cut=res.cut[b, :h, :w],
        state=st._replace(
            e=st.e[b, :h, :w], h=st.h[b, :h, :w],
            cap=st.cap[b, :, :h, :w],
            cap_src=st.cap_src[b, :h, :w],
            cap_sink=st.cap_sink[b, :h, :w],
            sink_flow=st.sink_flow[b], src_flow=st.src_flow[b],
            heur=None if st.heur is None else st.heur[b]),
        rounds=res.rounds[b],
        converged=res.converged[b],
        heuristics=None if res.heuristics is None else res.heuristics[b],
    )


def solve_prepared_maxflow(
    prep: PreparedBucket,
    *,
    backend: str = "xla",
    compact: bool = False,
    mesh=None,
    mesh_axis: str | None = None,
    **solver_kw,
) -> tuple[dict[int, GridFlowResult], BucketStats]:
    """DEVICE stage of the ``"maxflow"`` kind: one batched solve.

    Returns ``({request_position: result}, BucketStats)``; results are
    cropped back to each request's original (H, W).
    """
    res = maxflow_grid_batch(prep.stacked, backend=backend, compact=compact,
                             mesh=mesh, mesh_axis=mesh_axis, **solver_kw)
    out = {i: _crop_grid(res, b, *prep.shapes[b])
           for b, i in enumerate(prep.idxs)}
    return out, _stats("maxflow", prep, res.rounds, res.converged, compact,
                       heuristics=res.heuristics)


def solve_maxflow_batch(
    problems: Iterable[GridProblem],
    *,
    bucket: str = "max",
    compact: bool = False,
    mesh=None,
    mesh_axis: str | None = None,
    stats_out: list | None = None,
    **solver_kw,
) -> list[GridFlowResult]:
    """Solve many ragged grid-cut instances: ``solve_batch("maxflow",
    ...)``. ``**solver_kw`` forwards to ``maxflow_grid_batch``
    (``backend=``, ``max_rounds=``, ``device=``, ...). Returns one
    ``GridFlowResult`` per instance in input order, cropped back to the
    instance's original (H, W)."""
    return solve_batch("maxflow", problems, bucket=bucket, compact=compact,
                       mesh=mesh, mesh_axis=mesh_axis, stats_out=stats_out,
                       **solver_kw)


# -------------------------------------------------------------- assignment

def validate_assignment_matrix(w) -> np.ndarray:
    """Canonicalize + validate an assignment request (square int matrix)."""
    w = _host(w)
    if w.ndim != 2 or w.shape[0] != w.shape[1] \
            or not np.issubdtype(w.dtype, np.integer):
        raise ValueError(
            f"malformed assignment request: need a square integer "
            f"matrix, got shape {w.shape} dtype {w.dtype}")
    return w


def pad_cost_matrix(w, m: int):
    """Pad an (n, n) integer weight matrix to (m, m), optimum-preserving.

    The real block gets a uniform bonus ``1 - min(0, w.min())`` so every
    real-real arc strictly beats the zero-weight dummy arcs: every optimal
    perfect matching of the padded matrix matches real rows to real
    columns, and the real block's restriction is an optimal matching of
    the original. Padded weight = original weight + n * bonus. Caller must
    keep ``m * (m+1) * max|w + bonus|`` inside int32.

    Returns ``(padded int32 numpy array, bonus)``.
    """
    w = _host(w)
    n = w.shape[-1]
    assert m >= n, (m, n)
    assert np.issubdtype(w.dtype, np.integer), "integer weights only"
    bonus = int(1 - min(0, int(w.min()))) if n else 1
    out = np.zeros((m, m), np.int32)
    out[:n, :n] = w + bonus
    return out, bonus


def inert_cost_matrix(m: int) -> np.ndarray:
    """A zero-weight (m, m) instance: any perfect matching is optimal, the
    ε schedule collapses to one short ε=1 refine, and other instances
    never observe it."""
    return np.zeros((m, m), np.int32)


def prepare_assignment_buckets(
    costs: Sequence,
    *,
    bucket: str = "max",
    mesh=None,
    mesh_axis: str | None = None,
) -> list[PreparedBucket]:
    """HOST stage of the ``"assignment"`` kind: bucket, bonus-pad, stack.

    ``originals`` keeps the unpadded matrices so the device stage can
    recompute matching weights on the REAL costs.
    """
    costs = [_host(w) for w in costs]
    shapes = [(w.shape[-1],) for w in costs]

    def build(bshape, idxs, n_pad):
        (m,) = bshape
        mats = [pad_cost_matrix(costs[i], m)[0] for i in idxs]
        mats += [inert_cost_matrix(m)] * n_pad
        return np.stack(mats), tuple(costs[i] for i in idxs)

    return _make_buckets("assignment", shapes, bucket=bucket, mesh=mesh,
                         mesh_axis=mesh_axis, build=build)


def _crop_assignment(res: AssignmentResult, b: int, n: int,
                     original) -> AssignmentResult:
    """Instance ``b`` of a batched result cropped to its original n, the
    weight recomputed on the ORIGINAL costs."""
    col = res.col_of_row[b, :n]
    valid = col < n          # unconverged rows may hold dummy cols
    w = torch.as_tensor(np.asarray(original, np.int32), device=col.device)
    picked = torch.gather(w, 1, torch.clamp(col, max=n - 1).long()
                          .unsqueeze(-1)).squeeze(-1)
    weight = torch.where(valid, picked, 0).sum(dtype=torch.int32)
    return AssignmentResult(
        col_of_row=col, weight=weight,
        p_x=res.p_x[b, :n], p_y=res.p_y[b, :n],
        rounds=res.rounds[b], pushes=res.pushes[b],
        relabels=res.relabels[b], converged=res.converged[b],
    )


def solve_prepared_assignment(
    prep: PreparedBucket,
    *,
    compact: bool = False,
    mesh=None,
    mesh_axis: str | None = None,
    **solver_kw,
) -> tuple[dict[int, AssignmentResult], BucketStats]:
    """DEVICE stage of the ``"assignment"`` kind: one batched solve.

    Returns ``({request_position: result}, BucketStats)``; weights are
    recomputed on the ORIGINAL (unpadded) costs.
    """
    res = solve_assignment(prep.stacked, compact=compact, mesh=mesh,
                           mesh_axis=mesh_axis, **solver_kw)
    out = {i: _crop_assignment(res, b, prep.shapes[b][0],
                               prep.originals[b])
           for b, i in enumerate(prep.idxs)}
    return out, _stats("assignment", prep, res.rounds, res.converged,
                       compact)


def solve_assignment_batch(
    costs: Sequence,
    *,
    bucket: str = "max",
    compact: bool = False,
    mesh=None,
    mesh_axis: str | None = None,
    stats_out: list | None = None,
    **solver_kw,
) -> list[AssignmentResult]:
    """Solve many ragged assignment instances: ``solve_batch("assignment",
    ...)``. ``**solver_kw`` forwards to ``solve_assignment`` (``method=``,
    ``max_rounds=``, ``backend=``, ``device=``, ...).

    Returns one ``AssignmentResult`` per instance in input order:
    ``col_of_row`` cropped to the original n, ``weight`` recomputed on the
    ORIGINAL weights, prices cropped. Rows of an unconverged instance may
    point at dummy columns: they keep col values >= n and contribute 0 to
    ``weight``.
    """
    return solve_batch("assignment", costs, bucket=bucket, compact=compact,
                       mesh=mesh, mesh_axis=mesh_axis, stats_out=stats_out,
                       **solver_kw)


# --------------------------------------------- registry: the builtin kinds

def _maxflow_inert(shape: tuple) -> GridProblem:
    return inert_grid_problem(*shape)


def _maxflow_loop_spec(*, rounds_per_heuristic: int = 32,
                       max_rounds: int = 100_000, bfs_max_iters: int = 0,
                       backend: str = "xla", stall_threshold: float = 0.05):
    """The grid solver's cached ``LoopSpec`` factory (``maxflow_grid``
    defaults); see ``repro_torch.core.maxflow.grid``."""
    from repro_torch.core.maxflow.grid import _grid_spec
    return _grid_spec(rounds_per_heuristic, max_rounds, bfs_max_iters,
                      backend, stall_threshold)


def _maxflow_refill(*, rounds_per_heuristic: int = 32,
                    max_rounds: int = 100_000, bfs_max_iters: int = 0,
                    backend: str = "xla", stall_threshold: float = 0.05,
                    device=None) -> RefillRuntime:
    """The ``"maxflow"`` kind's continuous-batching runtime: the same
    spec, init and finalize as the compacted batch solve, so a refilled
    instance's trajectory equals its closed-batch solve. Problems use the
    public (B, 4, H, W) layout; init/finalize move the direction axis."""
    from repro_torch.core.maxflow.grid import (_grid_finalize, _grid_init,
                                               _grid_spec, _load)
    spec = _grid_spec(rounds_per_heuristic, max_rounds, bfs_max_iters,
                      backend, stall_threshold)
    dev = resolve_device(device)

    def pad_one(problem: GridProblem, shape) -> GridProblem:
        H, W = shape
        return stack_grid_problems([pad_grid_problem(problem, H, W)])

    def init(stacked: GridProblem):
        return _grid_init(torch.movedim(_load(stacked.cap_nbr, dev), 1, 0),
                          _load(stacked.cap_src, dev),
                          _load(stacked.cap_sink, dev),
                          bfs_max_iters=bfs_max_iters)

    def finalize(stacked, state, rounds) -> GridFlowResult:
        res = _grid_finalize(state, rounds, bfs_max_iters=bfs_max_iters)
        return res._replace(state=res.state._replace(
            cap=torch.movedim(res.state.cap, 0, 1).contiguous()))

    def crop(res: GridFlowResult, shape, original) -> GridFlowResult:
        return _crop_grid(res, 0, *shape)

    def shape_of(problem: GridProblem) -> tuple:
        return tuple(problem.cap_src.shape)

    return RefillRuntime(spec=spec, pad_one=pad_one, init=init,
                         finalize=finalize, crop=crop, shape_of=shape_of)


def _assignment_inert(shape: tuple) -> np.ndarray:
    return inert_cost_matrix(*shape)


def _assignment_refill(*, method: str = "auction", alpha: int = 10,
                       max_rounds: int = 200_000,
                       rounds_per_heuristic: int = 16,
                       use_price_update: bool = True,
                       use_arc_fixing: bool = True,
                       backend: str = "xla", device=None) -> RefillRuntime:
    """The ``"assignment"`` kind's continuous-batching runtime: bonus-
    shifted padding on the way in (``pad_cost_matrix``), weight recomputed
    on the ORIGINAL costs on the way out, as ``solve_prepared_assignment``
    crops."""
    from repro_torch.core.assignment.cost_scaling import (
        _assignment_finalize, _assignment_spec, _load_weights, _scale_init)
    spec = _assignment_spec(method, alpha, max_rounds, rounds_per_heuristic,
                            use_price_update, use_arc_fixing, backend)
    dev = resolve_device(device)

    def pad_one(w, shape):
        (m,) = shape
        return pad_cost_matrix(w, m)[0][None]

    def init(stacked):
        return _scale_init(_load_weights(stacked, dev), alpha=alpha)

    def finalize(stacked, state, rounds) -> AssignmentResult:
        # the solver's own per-instance counters live in the state; the
        # driver's rounds are unused (as in the closed-batch path)
        return _assignment_finalize(_load_weights(stacked, dev), state.st)

    def crop(res: AssignmentResult, shape, original) -> AssignmentResult:
        return _crop_assignment(res, 0, shape[0], original)

    def shape_of(w) -> tuple:
        return (int(w.shape[-1]),)

    return RefillRuntime(spec=spec, pad_one=pad_one, init=init,
                         finalize=finalize, crop=crop, shape_of=shape_of)


def _assignment_loop_spec(*, method: str = "auction", alpha: int = 10,
                          max_rounds: int = 200_000,
                          rounds_per_heuristic: int = 16,
                          use_price_update: bool = True,
                          use_arc_fixing: bool = True,
                          backend: str = "xla"):
    """The assignment solver's cached ``LoopSpec`` factory
    (``solve_assignment`` defaults); see ``repro_torch.core.assignment``."""
    from repro_torch.core.assignment.cost_scaling import _assignment_spec
    return _assignment_spec(method, alpha, max_rounds, rounds_per_heuristic,
                            use_price_update, use_arc_fixing, backend)


# ------------------------------------------------------ warm-start hooks
# (repro_torch.core.warm drives these)


def _pad_trailing(a, shape, fill=0) -> torch.Tensor:
    """Pad the trailing ``len(shape)`` axes of ``a`` (a tensor or array)
    up to ``shape`` with ``fill``; the dtype is kept."""
    a = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a, copy=True))
    tail = a.shape[a.dim() - len(shape):]
    pads = []
    for s, t in reversed(list(zip(tail, shape))):
        pads += [0, t - s]
    return torch.nn.functional.pad(a, pads, value=fill) if any(pads) else a


def _maxflow_init_state(**solver_kw):
    """Cold per-instance init for the ``"maxflow"`` kind: the refill
    runtime's init, so warm/cold mixing shares one code path."""
    return _maxflow_refill(**solver_kw).init


def _maxflow_warm_state(*, rounds_per_heuristic: int = 32,
                        max_rounds: int = 100_000, bfs_max_iters: int = 0,
                        backend: str = "xla", stall_threshold: float = 0.05,
                        device=None):
    """Warm per-instance init: recover the prior flow from the cached
    residuals, clamp and repair it against the mutated capacities and
    re-BFS the heights (``repro_torch.core.maxflow.grid._grid_warm``).
    Without a base problem the prior flow is unrecoverable from residuals
    alone, so the hook falls back to the cold init."""
    from repro_torch.core.maxflow.grid import _grid_init, _grid_warm, _load
    dev = resolve_device(device)

    def warm1(problem1: GridProblem, solution, *, base_problem1=None,
              delta_bound=None):
        cap = torch.movedim(_load(problem1.cap_nbr, dev), 1, 0)
        cs = _load(problem1.cap_src, dev)
        ct = _load(problem1.cap_sink, dev)
        if base_problem1 is None:
            return _grid_init(cap, cs, ct, bfs_max_iters=bfs_max_iters)
        H, W = cs.shape[-2:]
        bcap = torch.movedim(_load(base_problem1.cap_nbr, dev), 1, 0)
        bct = _load(base_problem1.cap_sink, dev)
        # cached solution arrays are at the ORIGINAL (h, w); inert padding
        # carries no flow, so zero-extending them to the bucket is exact
        pcap = _pad_trailing(solution["cap"], (H, W))[:, None].to(dev)
        pct = _pad_trailing(solution["cap_sink"], (H, W))[None].to(dev)
        return _grid_warm(cap, cs, ct, bcap, bct, pcap, pct,
                          bfs_max_iters=bfs_max_iters)

    return warm1


def _maxflow_solution_of(res: GridFlowResult):
    """Cacheable artifact: the residual capacities (grid + sink edges);
    with the base problem they reconstruct the full prior flow."""
    return {"cap": res.state.cap, "cap_sink": res.state.cap_sink}


def _assignment_init_state(**solver_kw):
    return _assignment_refill(**solver_kw).init


def _assignment_warm_state(*, method: str = "auction", alpha: int = 10,
                           max_rounds: int = 200_000,
                           rounds_per_heuristic: int = 16,
                           use_price_update: bool = True,
                           use_arc_fixing: bool = True,
                           backend: str = "xla", device=None):
    """Warm per-instance init: re-enter the ε ladder at a delta-bounded
    rung with the prior column prices (``_scale_warm``, correct for ANY
    prices). ``delta_bound`` (max |Δw| on the original weights) becomes a
    scaled-cost bound of ``(m+1)·2·ceil(Δw)``, capped at ``2 ** 30`` (the
    factor 2 covers the bonus shift drifting with ``min(w)``); with no
    bound the ladder re-enters at the cold rung and only the prices carry
    over."""
    from repro_torch.core.assignment.cost_scaling import (_load_weights,
                                                          _scale_warm)
    dev = resolve_device(device)

    def warm1(stacked1, solution, *, base_problem1=None, delta_bound=None):
        w = _load_weights(stacked1, dev)
        m = int(w.shape[-1])
        p_y = _pad_trailing(solution["p_y"], (m,)).to(
            device=dev, dtype=torch.int32)[None]
        if delta_bound is None:
            d = 2 ** 30                                  # clamps to cold ε
        else:
            d = min(2 ** 30, (m + 1) * 2 * int(np.ceil(delta_bound)))
        dmax = torch.full((1,), d, dtype=torch.int32, device=dev)
        return _scale_warm(w, p_y, dmax, alpha=alpha)

    return warm1


def _assignment_solution_of(res: AssignmentResult):
    """Cacheable artifact: the column prices (the dual half the warm
    ladder reuses)."""
    return {"p_y": res.p_y}


register_kind(SolverKind(
    name="maxflow",
    validate=validate_grid_problem,
    inert_problem=_maxflow_inert,
    prepare_buckets=prepare_maxflow_buckets,
    solve_prepared=solve_prepared_maxflow,
    loop_spec=_maxflow_loop_spec,
    refill=_maxflow_refill,
    init_state=_maxflow_init_state,
    warm_state=_maxflow_warm_state,
    solution_of=_maxflow_solution_of,
))

register_kind(SolverKind(
    name="assignment",
    validate=validate_assignment_matrix,
    inert_problem=_assignment_inert,
    prepare_buckets=prepare_assignment_buckets,
    solve_prepared=solve_prepared_assignment,
    loop_spec=_assignment_loop_spec,
    refill=_assignment_refill,
    init_state=_assignment_init_state,
    warm_state=_assignment_warm_state,
    solution_of=_assignment_solution_of,
))
