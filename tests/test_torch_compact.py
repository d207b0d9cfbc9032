"""Early-exit compaction and cycle telemetry: the port against the JAX
package.

``compact=True`` changes WHICH instances a cycle computes, never WHAT an
instance computes: for every maxflow backend, both assignment methods on
both backends, and matching on both backends, the port's compacted solve
equals its masked solve, a loop of its single solves, and the JAX
package's compacted solve (Pallas kernels in interpret mode), on every
leaf and counter. The instances are chosen so that convergence is ragged
(asserted), which is when compaction gathers. Also checked: the rounds
cap, ``bucket_size``, ``run_compacted`` over two lanes, that the caller's
state is never written, the ``CycleEvent`` streams of compacted solves and
of masked solves under ``cycle_events(masked=True, detail=True)`` field
for field, the ``trace_cycles`` shim, and the errors and lanes of
compacted solves (``mesh=``, ROADMAP M7). Tolerance: exact equality (``assert_same``); the
instances are integer-valued.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same

from repro.core import solver_loop as jloop
from repro.core.assignment import cost_scaling as jc
from repro.core.matching import bfs as jm
from repro.core.maxflow import grid as jg
from repro_torch.core import solver_loop as tloop
from repro_torch.core.assignment import cost_scaling as tc
from repro_torch.core.matching import bfs as tm
from repro_torch.core.matching.ref import random_bipartite
from repro_torch.core.maxflow import grid as tg
from repro_torch.core.maxflow.ref import random_grid_problem
from repro_torch.launch.mesh import compact_lanes, make_solver_mesh

CPU = "cpu"


def ragged_grids(seed: int, B: int, H: int = 8, W: int = 8):
    """(cap, cs, ct) stacks with ragged convergence: 3 of every 4
    instances carry little source capacity and finish early."""
    rng = np.random.default_rng(seed)
    probs = []
    for i in range(B):
        cap, cs, ct = random_grid_problem(rng, H, W)
        if i % 4:
            cs = np.minimum(cs, 1.0)
        probs.append((cap, cs, ct))
    return tuple(np.stack([p[k] for p in probs]) for k in range(3))


def ragged_weights(seed: int, B: int, n: int = 10) -> np.ndarray:
    """Weight stacks whose ε schedules differ in length."""
    ws = np.stack([np.random.default_rng(seed + i).integers(0, 101, (n, n))
                   for i in range(B)])
    ws[::3] //= 9
    return ws


def chain(n: int) -> np.ndarray:
    """One long augmenting path per phase: many phases without greedy."""
    adj = np.zeros((n, n), bool)
    for i in range(n):
        for j in (i, i + 1):
            if j < n:
                adj[i, n - 1 - j] = True
    return adj


def ragged_graphs(seed: int) -> np.ndarray:
    """Six 12 x 12 graphs: a chain, random ones of several densities and
    an edge-less one (born converged)."""
    rng = np.random.default_rng(seed)
    graphs = [chain(12)] + [random_bipartite(rng, 12, 12, p)
                            for p in (0.1, 0.3, 0.15, 0.5)]
    graphs.append(np.zeros((12, 12), bool))
    return np.stack(graphs)


def jgrid(cap, cs, ct):
    return jg.GridProblem(*map(jnp.asarray, (cap, cs, ct)))


def assert_ragged(rounds):
    r = np.asarray(rounds)
    assert r.max() > r.min(), f"convergence not ragged: {r}"


def test_bucket_size_matches_jax():
    for cap in (1, 5, 8, 16):
        for n in range(1, cap + 1):
            assert tloop.bucket_size(n, cap) == jloop.bucket_size(n, cap)
    assert [tloop.bucket_size(n, 8) for n in (1, 2, 3, 4, 5, 7, 8)] \
        == [1, 2, 4, 4, 8, 8, 8]


@pytest.mark.parametrize("backend", list(tg.VALID_BACKENDS))
def test_maxflow_compact_equals_masked_singles_and_jax(backend):
    cap, cs, ct = ragged_grids(0, 6)
    want = jg.maxflow_grid_batch(jgrid(cap, cs, ct), backend=backend,
                                 compact=True)
    got = tg.maxflow_grid_batch(tg.GridProblem(cap, cs, ct),
                                backend=backend, compact=True, device=CPU)
    masked = tg.maxflow_grid_batch(tg.GridProblem(cap, cs, ct),
                                   backend=backend, device=CPU)
    assert_same(got, want)
    assert_same(got, masked)
    assert_ragged(got.rounds)
    for b in range(cap.shape[0]):
        one = tg.maxflow_grid(tg.GridProblem(cap[b], cs[b], ct[b]),
                              backend=backend, device=CPU)
        assert float(got.flow[b]) == float(one.flow)
        assert int(got.rounds[b]) == int(one.rounds)
        assert int(got.heuristics[b]) == int(one.heuristics)
        assert torch.equal(got.cut[b], one.cut)
        assert torch.equal(got.state.e[b], one.state.e)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("method", ["auction", "pushrelabel"])
def test_assignment_compact_equals_masked_singles_and_jax(method, backend):
    ws = ragged_weights(0, 5)
    want = jc.solve_assignment(jnp.asarray(ws, jnp.int32), method=method,
                               backend=backend, compact=True)
    got = tc.solve_assignment(ws, method=method, backend=backend,
                              compact=True, device=CPU)
    masked = tc.solve_assignment(ws, method=method, backend=backend,
                                 device=CPU)
    assert_same(got, want)
    assert_same(got, masked)
    assert_ragged(got.rounds)
    for b in range(ws.shape[0]):
        one = tc.solve_assignment(ws[b], method=method, backend=backend,
                                  device=CPU)
        for name in one._fields:
            assert torch.equal(getattr(got, name)[b], getattr(one, name))


@pytest.mark.parametrize("greedy_init", [True, False])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_matching_compact_equals_masked_singles_and_jax(backend,
                                                       greedy_init):
    adj = ragged_graphs(0)
    kw = dict(backend=backend, greedy_init=greedy_init)
    want = jm.match_bipartite_batch(jnp.asarray(adj), compact=True, **kw)
    got = tm.match_bipartite_batch(adj, compact=True, device=CPU, **kw)
    masked = tm.match_bipartite_batch(adj, device=CPU, **kw)
    assert_same(got, want)
    assert_same(got, masked)
    assert_ragged(got.rounds)
    for b in range(adj.shape[0]):
        one = tm.match_bipartite(adj[b], device=CPU, **kw)
        for name in one._fields:
            assert torch.equal(getattr(got, name)[b], getattr(one, name))


def test_rounds_cap_leaves_through_the_cap():
    """max_rounds=2: instances leave the live set through the cap, not
    convergence; identical flags and partial states in every driver."""
    cap, cs, ct = ragged_grids(1, 4)
    kw = dict(max_rounds=2, rounds_per_heuristic=2)
    want = jg.maxflow_grid_batch(jgrid(cap, cs, ct), compact=True, **kw)
    got = tg.maxflow_grid_batch(tg.GridProblem(cap, cs, ct), compact=True,
                                device=CPU, **kw)
    assert_same(got, want)
    assert_same(got, tg.maxflow_grid_batch(tg.GridProblem(cap, cs, ct),
                                           device=CPU, **kw))
    assert not bool(got.converged.all())

    ws = ragged_weights(2, 4)
    want = jc.solve_assignment(jnp.asarray(ws, jnp.int32), compact=True,
                               max_rounds=2, rounds_per_heuristic=1)
    got = tc.solve_assignment(ws, compact=True, max_rounds=2,
                              rounds_per_heuristic=1, device=CPU)
    assert_same(got, want)

    adj = ragged_graphs(3)
    want = jm.match_bipartite_batch(jnp.asarray(adj), compact=True,
                                    max_rounds=2, greedy_init=False)
    got = tm.match_bipartite_batch(adj, compact=True, max_rounds=2,
                                   greedy_init=False, device=CPU)
    assert_same(got, want)
    assert not bool(got.converged.all())


def _grid_state_and_spec(seed: int, B: int):
    cap, cs, ct = ragged_grids(seed, B)
    t = tg._grid_init(torch.movedim(torch.tensor(cap), 1, 0),
                      torch.tensor(cs), torch.tensor(ct), bfs_max_iters=0)
    j = jg._grid_init_jit(jnp.moveaxis(jnp.asarray(cap), 1, 0),
                          jnp.asarray(cs), jnp.asarray(ct), bfs_max_iters=0)
    return (t, tg._grid_spec(32, 100_000, 0, "xla")), \
        (j, jg._grid_spec(32, 100_000, 0, "xla"))


def test_two_lanes_equal_one_and_jax():
    """Contiguous lanes compact on their own: two lanes give one lane's
    results and the JAX driver's, events included."""
    (t, tspec), (j, jspec) = _grid_state_and_spec(4, 6)
    lanes = [(0, 3, None), (3, 6, None)]
    ev_t, ev_j = [], []
    with tloop.cycle_events(ev_t.append, detail=True):
        got = tloop.run_compacted(tspec, t, 6, lanes=lanes)
    with jloop.cycle_events(ev_j.append, detail=True):
        want = jloop.run_compacted(jspec, j, 6, lanes=lanes)
    assert_same(got, want)
    assert_same(got, tloop.run_compacted(tspec, t, 6))
    assert ev_t == ev_j and ev_t


def test_run_compacted_never_writes_the_callers_state():
    (t, spec), _ = _grid_state_and_spec(5, 5)
    before = [x.clone() if x is not None else None for x in t]
    state, rounds = tloop.run_compacted(spec, t, 5)
    assert_ragged(rounds)
    for x, y in zip(t, before):
        assert (x is None and y is None) or torch.equal(x, y)
    assert not torch.equal(state.e, t.e)


def _events(ce, fn, **kw):
    evs = []
    with ce(evs.append, **kw):
        res = fn()
    return res, evs


def _solves(backend="xla"):
    """(name, jax solve, port solve) of one ragged batch per kind, with a
    ``compact`` switch."""
    cap, cs, ct = ragged_grids(6, 6)
    ws = ragged_weights(7, 5)
    adj = ragged_graphs(8)
    return [
        ("maxflow",
         lambda c: jg.maxflow_grid_batch(jgrid(cap, cs, ct), compact=c,
                                         backend=backend),
         lambda c: tg.maxflow_grid_batch(tg.GridProblem(cap, cs, ct),
                                         compact=c, backend=backend,
                                         device=CPU)),
        ("assignment",
         lambda c: jc.solve_assignment(jnp.asarray(ws, jnp.int32),
                                       compact=c, backend=backend),
         lambda c: tc.solve_assignment(ws, compact=c, backend=backend,
                                       device=CPU)),
        ("matching",
         lambda c: jm.match_bipartite_batch(jnp.asarray(adj), compact=c,
                                            backend=backend),
         lambda c: tm.match_bipartite_batch(adj, compact=c, backend=backend,
                                            device=CPU)),
    ]


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("detail", [True, False])
def test_cycle_event_streams_equal_jax(compact, detail):
    """Compacted solves emit under any hook, masked ones under
    ``masked=True``; every field equals the reference's (the counts do
    not depend on the machine). ``heur_total`` only for maxflow with
    ``detail=True``."""
    for kind, jsolve, tsolve in _solves():
        want, ev_j = _events(jloop.cycle_events, lambda: jsolve(compact),
                             masked=not compact, detail=detail)
        got, ev_t = _events(tloop.cycle_events, lambda: tsolve(compact),
                            masked=not compact, detail=detail)
        assert_same(got, want)
        assert ev_t == ev_j, kind
        assert ev_t and all(isinstance(e, tloop.CycleEvent) for e in ev_t)
        assert {e.driver for e in ev_t} == {
            "compacted" if compact else "masked"}
        has_heur = detail and kind == "maxflow"
        assert all((e.heur_total is not None) == has_heur for e in ev_t)
        if not compact:
            assert all(e.gathered == len(got.rounds) for e in ev_t)
        else:
            assert all(e.gathered >= e.n_live for e in ev_t)


def test_masked_solves_emit_only_when_asked():
    """Without ``masked=True`` a masked solve emits nothing; the hook is
    gone once its context exits."""
    _, _, tsolve = _solves()[0]
    _, evs = _events(tloop.cycle_events, lambda: tsolve(False))
    assert evs == []
    assert not tloop.masked_events_active()
    with tloop.cycle_events(lambda ev: None, masked=True):
        assert tloop.masked_events_active()
    assert not tloop.masked_events_active()


def test_trace_cycles_shim_matches_jax():
    for _, jsolve, tsolve in _solves():
        calls_j, calls_t = [], []
        with jloop.trace_cycles(lambda c, n: calls_j.append((c, n))):
            jsolve(True)
            jsolve(False)              # masked solves do not emit
        with tloop.trace_cycles(lambda c, n: calls_t.append((c, n))):
            tsolve(True)
            tsolve(False)
        assert calls_t == calls_j and calls_t[0][0] == 0
        assert all(isinstance(c, int) and isinstance(n, int)
                   for c, n in calls_t)
        n = len(calls_t)
        tsolve(True)
        assert len(calls_t) == n, "shim hook leaked past its context"


def test_compact_errors():
    w = np.random.default_rng(0).integers(0, 9, (5, 5))
    with pytest.raises(ValueError, match="batched"):
        tc.solve_assignment(w, compact=True, device=CPU)
    cap, cs, ct = ragged_grids(9, 2)
    two_lanes = make_solver_mesh(2, device=CPU)
    with pytest.raises(ValueError, match="not in mesh axes"):
        tg.maxflow_grid_batch(tg.GridProblem(cap, cs, ct), compact=True,
                              mesh=two_lanes, mesh_axis="model", device=CPU)
    with pytest.raises(ValueError, match="not divisible"):
        compact_lanes(two_lanes, None, 3)
    # lanes keep compaction within each lane: equal results
    w = ragged_weights(0, 3)
    assert_same(tc.solve_assignment(w, compact=True, mesh=two_lanes,
                                    device=CPU),
                tc.solve_assignment(w, compact=True, device=CPU))
    # a mesh axis without a mesh is ignored, as in the reference
    assert_same(tm.match_bipartite_batch(ragged_graphs(0), compact=True,
                                         mesh_axis="batch", device=CPU),
                tm.match_bipartite_batch(ragged_graphs(0), compact=True,
                                         device=CPU))
    with pytest.raises(ValueError, match="unknown backend"):
        tm.match_bipartite_batch(ragged_graphs(0), compact=True,
                                 backend="nope", device=CPU)
