"""Device lanes (``repro_torch.launch.mesh``): the port's form of the
reference's solver mesh, against the JAX package's UNSHARDED results.

The reference shards a batch across a device mesh under ``shard_map``
(``tests/test_shard.py``, and ``tests/test_warm.py``'s sharded warm
case); the port splits it into lanes, contiguous slices each solved on
its lane's device. Several lanes on the CPU stand in for several cards.
Checked: the lane set's construction and errors, ``compact_lanes``,
``scheduler_lanes``, ``shard_batched``'s zero padding; then
``solve_batch`` (every kind, masked and compacted), the three batched
entry points, ``solve_warm`` and ``RefillSolver`` on 1, 2 and 3 lanes at
batch sizes that need inert padding, each equal leaf for leaf to the
port's solve without lanes and to the JAX package's unsharded solve
(the reference's sharded path itself does not run under jax 0.9.0,
ROADMAP F1). Tolerance: exact equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same

import repro.core.batch as jb
import repro.core.warm as jw
from repro.core.assignment.cost_scaling import \
    solve_assignment as jsolve_assignment
from repro.core.matching import match_bipartite_batch as jmatch_batch
from repro.core.maxflow.grid import maxflow_grid_batch as jgrid_batch
from repro_torch.core import batch as tb
from repro_torch.core import warm as tw
from repro_torch.core.assignment.cost_scaling import solve_assignment
from repro_torch.core.kinds import get_kind
from repro_torch.core.matching import match_bipartite_batch
from repro_torch.core.matching.ref import random_bipartite
from repro_torch.core.maxflow.grid import GridProblem, maxflow_grid_batch
from repro_torch.core.maxflow.ref import random_grid_problem
from repro_torch.core.refill import RefillSolver
from repro_torch.launch.mesh import (SolverMesh, compact_lanes,
                                     dispatch_sharded, make_solver_mesh,
                                     scheduler_lanes, shard_batched,
                                     shard_count, solver_batch_axis)

CPU = "cpu"
KINDS = ["maxflow", "assignment", "matching"]
LANES = [1, 2, 3]


def _queue(kind, seed=2):
    """Five ragged requests: five divides into neither 2 nor 3 lanes."""
    rng = np.random.default_rng(seed)
    if kind == "maxflow":
        return [GridProblem(*random_grid_problem(rng, h, w))
                for h, w in [(5, 5), (8, 8), (4, 7), (8, 8), (5, 5)]]
    if kind == "assignment":
        return [rng.integers(-30, 71, (n, n)) for n in (4, 9, 6, 9, 5)]
    return [random_bipartite(rng, nl, nr, 0.3)
            for nl, nr in [(5, 7), (9, 9), (3, 4), (9, 6), (7, 7)]]


def _jax(kind, p):
    if kind == "maxflow":
        return jb.GridProblem(*(jnp.asarray(np.asarray(a)) for a in p))
    return np.asarray(p)


def _lanes(n):
    return make_solver_mesh(n, device=CPU)


def test_solver_mesh_shape():
    mesh = _lanes(3)
    assert isinstance(mesh, SolverMesh)
    assert mesh.axis_names == ("batch",)
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert solver_batch_axis(mesh) == "batch"
    assert shard_count(mesh) == shard_count(mesh, "batch") == 3
    assert make_solver_mesh(device=CPU).devices == (torch.device("cpu"),)
    assert make_solver_mesh(2, axis="lanes", device=CPU).axis_names == \
        ("lanes",)
    with pytest.raises(ValueError):
        solver_batch_axis(mesh, "model")
    with pytest.raises(ValueError):
        make_solver_mesh(0, device=CPU)


def test_default_mesh_is_the_cards(monkeypatch):
    """Without ``device`` the lanes are the CUDA devices: none here, so
    it raises; with one card, one lane, and more lanes than cards raise
    ``ValueError`` as the reference's ``make_solver_mesh`` does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_solver_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert make_solver_mesh().devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="outside"):
        make_solver_mesh(2)


def test_compact_and_scheduler_lanes():
    mesh = _lanes(3)
    assert compact_lanes(mesh, None, 6) == [(0, 2, torch.device("cpu")),
                                           (2, 4, torch.device("cpu")),
                                           (4, 6, torch.device("cpu"))]
    with pytest.raises(ValueError, match="not divisible"):
        compact_lanes(mesh, None, 5)
    assert scheduler_lanes(None, n_lanes=3) == [None] * 3
    assert scheduler_lanes(_lanes(1), n_lanes=2) == [_lanes(1)] * 2
    five = _lanes(5)
    assert [len(m.devices) for m in scheduler_lanes(five, n_lanes=2)] == \
        [3, 2]
    with pytest.raises(ValueError, match="n_lanes"):
        scheduler_lanes(five, n_lanes=0)


def test_shard_batched_pads_and_concatenates():
    """Each lane sees an equal slice (zero-padded), the result is cropped
    back in order, on the arguments' device."""
    seen = []

    def fn(x, y):
        seen.append((x.shape[0], x.clone()))
        return {"sum": x + y, "rows": x.sum(-1)}

    x = torch.arange(10, dtype=torch.int32).reshape(5, 2)
    y = np.ones((5, 2), np.int32)
    out = shard_batched(fn, _lanes(3))(x, torch.as_tensor(y))
    assert [n for n, _ in seen] == [2, 2, 2]
    assert seen[-1][1][1].tolist() == [0, 0]          # the zero pad
    assert_same(out, {"sum": x + 1, "rows": x.sum(-1)})
    out = dispatch_sharded(lambda a, k: a * k, (x,), 5, _lanes(2), None,
                           k=3)
    assert_same(out, x * 3)
    with pytest.raises(ValueError, match="batch size"):
        dispatch_sharded(lambda a: a, (x,), 4, _lanes(2), None)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_solve_batch_on_lanes_equals_unsharded_and_jax(kind, compact):
    """The reference's ragged-front-end shard cases, every kind: the
    bucket pads with inert instances to the lanes (``BucketStats.n_pad``)
    and every result equals the unsharded solve's."""
    payloads = _queue(kind)
    want = jb.solve_batch(kind, [_jax(kind, p) for p in payloads],
                          bucket="max")
    base = tb.solve_batch(kind, payloads, bucket="max", device=CPU)
    for n in LANES:
        stats = []
        got = tb.solve_batch(kind, payloads, bucket="max", compact=compact,
                             mesh=_lanes(n), stats_out=stats, device=CPU)
        assert [s.n_pad for s in stats] == [-5 % n]
        prep = tb.prepare_buckets(kind, payloads, mesh=_lanes(n))
        assert prep[0].n_pad == -5 % n and prep[0].stacked is not None
        for g, b, w in zip(got, base, want):
            assert_same(g, b)
            assert_same(g, w)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("backend", ["xla", "multipush", "pallas",
                                     "balanced"])
def test_maxflow_grid_batch_on_lanes(backend, compact):
    rng = np.random.default_rng(0)
    probs = [random_grid_problem(rng, 8, 8) for _ in range(5)]
    stack = GridProblem(*(np.stack([p[k] for p in probs]) for k in range(3)))
    want = jgrid_batch(jb.GridProblem(*map(jnp.asarray, stack)),
                       backend=backend)
    for n in LANES:
        got = maxflow_grid_batch(stack, backend=backend, compact=compact,
                                 mesh=_lanes(n), device=CPU)
        assert_same(got, want)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("method", ["auction", "pushrelabel"])
def test_solve_assignment_on_lanes(method, compact):
    """Ragged difficulty: instance 0 has a shorter ε schedule, so lanes
    carry different amounts of work."""
    ws = np.stack([np.random.default_rng(i).integers(0, 101, (10, 10))
                   for i in range(5)])
    ws[0] //= 9
    want = jsolve_assignment(jnp.asarray(ws), method=method)
    for n in LANES:
        got = solve_assignment(ws, method=method, compact=compact,
                               mesh=_lanes(n), device=CPU)
        assert_same(got, want)
    with pytest.raises(ValueError, match="batched"):
        solve_assignment(ws[0], mesh=_lanes(2), device=CPU)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_match_bipartite_batch_on_lanes(backend, compact):
    rng = np.random.default_rng(3)
    adj = np.stack([random_bipartite(rng, 12, 10, p)
                    for p in (0.1, 0.3, 0.2, 0.05, 0.4)])
    want = jmatch_batch(jnp.asarray(adj), backend=backend)
    for n in LANES:
        got = match_bipartite_batch(adj, backend=backend, compact=compact,
                                    mesh=_lanes(n), device=CPU)
        assert_same(got, want)
    with pytest.raises(ValueError, match="unknown backend"):
        match_bipartite_batch(adj, backend="nope", mesh=_lanes(2),
                              device=CPU)


@pytest.mark.parametrize("kind", KINDS)
def test_solve_warm_on_lanes_matches_unsharded(kind):
    """The port's form of the reference's sharded warm case: every
    instance warm, five of them on 1, 2 and 3 lanes, equal to the
    unsharded warm solve of both packages."""
    payloads = _queue(kind, seed=4)
    k = get_kind(kind)
    sols = [k.solution_of(r)
            for r in tb.solve_batch(kind, payloads, device=CPU)]
    rng = np.random.default_rng(5)
    if kind == "maxflow":
        mutated = [GridProblem(p.cap_nbr, p.cap_src, np.maximum(
            p.cap_sink + rng.integers(-2, 3, p.cap_sink.shape), 0)
            .astype(np.float32)) for p in payloads]
    elif kind == "assignment":
        mutated = [np.maximum(w + rng.integers(-3, 4, w.shape), -30)
                   for w in payloads]
    else:
        mutated = [a ^ (rng.random(a.shape) < 0.1) for a in payloads]
    warm = {i: tw.WarmStart(sols[i], base_problem=payloads[i])
            for i in range(5)}
    plain = tw.solve_warm(kind, mutated, warm, device=CPU)
    want = jw.solve_warm(kind, [_jax(kind, p) for p in mutated], {
        i: jw.WarmStart({key: np.asarray(v) for key, v in ws.solution.items()},
                        base_problem=_jax(kind, ws.base_problem))
        for i, ws in warm.items()})
    for n in LANES:
        stats = []
        lanes = tw.solve_warm(kind, mutated, warm, mesh=_lanes(n),
                              stats_out=stats, device=CPU)
        assert all(s.compact for s in stats)
        for a, b, w in zip(lanes, plain, want):
            assert_same(a, b)
            assert_same(a, w)


@pytest.mark.parametrize("kind", KINDS)
def test_refill_on_lanes_equals_closed_batch(kind):
    """Six slots on 1, 2 and 3 lanes; seven requests, the rest admitted
    as slots free up within their lanes; every result equals the closed
    batch at the session's shape, in both packages."""
    payloads = _queue(kind, seed=6) + _queue(kind, seed=7)[:2]
    shape = {"maxflow": (8, 8), "assignment": (9,),
             "matching": (9, 9)}[kind]
    want = jb.solve_batch(kind, [_jax(kind, p) for p in payloads],
                          bucket="max")
    for n in LANES:
        queue = list(payloads[6:])

        def admit(n_free):
            out, queue[:n_free] = list(queue[:n_free]), []
            return out

        got = RefillSolver(kind, shape=shape, capacity=6, mesh=_lanes(n),
                           device=CPU).run(payloads[:6], admit=admit)
        assert sorted(got) == list(range(7))
        for i in range(7):
            assert_same(got[i], want[i])
    with pytest.raises(ValueError, match="not divisible"):
        RefillSolver(kind, shape=shape, capacity=4, mesh=_lanes(3),
                     device=CPU)
