"""The synchronous solver engine (``SolverEngine``, ROADMAP M8): the port
against the JAX package.

Ported case for case from ``tests/test_engine.py`` (submit-time
validation before a ticket, the empty flush, ticket order across rounds
and kinds, partial-failure delivery, a submit during a flush, ticket-
ordered results, ``stats_out``), the engine cases of ``tests/test_kinds.py``
(unknown kinds, the deprecated ``maxflow_kw`` / ``assignment_kw`` and
``submit_*`` spellings with their ``DeprecationWarning``),
``tests/test_matching.py`` (the matching kind through the engine, on two
CPU lanes), ``tests/test_compact.py`` (a compacting engine) and
``tests/test_warm.py`` (``submit(base=, delta=)`` with the cache metrics).
Every ``flush`` result is held leaf for leaf, dtypes and counters
included, to the reference's ``flush`` of the same queue (``assert_same``,
exact). Also checked: the engine solves on the card unless told
otherwise, and owns the device its kinds solve on.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same

import repro.core.warm as jwarm
import repro.serve.engine as jengine
import repro.serve.metrics as jmetrics
import repro_torch.core.kinds as kinds_mod
from repro.core.maxflow.grid import GridProblem as JGridProblem
from repro_torch.core.batch import prepare_buckets, solve_batch
from repro_torch.core.kinds import get_kind
from repro_torch.core.matching import validate_matching_problem
from repro_torch.core.matching.ref import random_bipartite
from repro_torch.core.maxflow.grid import GridProblem
from repro_torch.core.maxflow.ref import maxflow_grid_ref, random_grid_problem
from repro_torch.core.warm import GraphDelta, apply_delta
from repro_torch.launch.mesh import make_solver_mesh
from repro_torch.serve.engine import (SolverEngine,
                                      validate_assignment_matrix,
                                      validate_grid_problem)
from repro_torch.serve.metrics import SchedulerMetrics

CPU = "cpu"


def _prob(rng, h=6, w=6):
    return GridProblem(*random_grid_problem(rng, h, w))


def _jax(kind, payload):
    if kind == "maxflow":
        return JGridProblem(*map(jnp.asarray, payload))
    return payload


class _Both:
    """One queue into the port's engine and the reference's at once."""

    def __init__(self, **kw):
        self.eng = SolverEngine(device=CPU, **kw)
        self.jeng = jengine.SolverEngine(**kw)

    def submit(self, kind, payload):
        t = self.eng.submit(kind, payload)
        assert self.jeng.submit(kind, _jax(kind, payload)) == t
        return t

    def flush(self, **kw):
        """The port's flush, held to the reference's leaf for leaf."""
        got, want = self.eng.flush(**kw), self.jeng.flush()
        assert list(got) == list(want)
        for t in got:
            assert_same(got[t], want[t])
        return got


# ---------------------------------------------------------- validation

def test_submit_rejects_bad_values_before_ticket():
    engine = SolverEngine(device=CPU)
    good = _prob(np.random.default_rng(0))
    neg = GridProblem(good.cap_nbr, -good.cap_src, good.cap_sink)
    with pytest.raises(ValueError, match="negative"):
        engine.submit("maxflow", neg)
    nan = GridProblem(good.cap_nbr, np.full_like(good.cap_src, np.nan),
                      good.cap_sink)
    with pytest.raises(ValueError, match="non-finite"):
        engine.submit("maxflow", nan)
    boolean = GridProblem(np.zeros((4, 6, 6), np.bool_), good.cap_src,
                          good.cap_sink)
    with pytest.raises(ValueError, match="non-numeric"):
        engine.submit("maxflow", boolean)
    # the reject-before-ticket contract: nothing was queued, and the next
    # good submit gets ticket 0 (no ticket was burned on a rejection)
    assert engine.pending() == 0
    assert engine.submit("maxflow", good) == 0


def test_submit_unknown_kind_names_registered_ones():
    engine = SolverEngine(device=CPU)
    with pytest.raises(ValueError, match="registered kinds.*maxflow"):
        engine.submit("tsp", object())
    assert engine.pending() == 0


def test_validators_canonicalize_good_requests():
    rng = np.random.default_rng(1)
    p = validate_grid_problem(_prob(rng))
    assert isinstance(p, GridProblem)
    # integer capacities are fine (float sums over them stay exact)
    ints = GridProblem(np.ones((4, 3, 3), np.int32),
                       np.ones((3, 3), np.int32), np.ones((3, 3), np.int32))
    validate_grid_problem(ints)
    w = validate_assignment_matrix([[1, 2], [3, 4]])
    assert w.shape == (2, 2) and np.issubdtype(w.dtype, np.integer)
    with pytest.raises(ValueError, match="malformed assignment"):
        validate_assignment_matrix(np.ones((2, 2)))          # float


# ---------------------------------------------------------- empty / mixed

def test_flush_empty_queue_returns_empty_dict():
    engine = SolverEngine(device=CPU)
    assert engine.flush() == {}
    assert engine.flush() == {}          # idempotent, still no dispatch


def test_mixed_kind_queue_with_one_kind_empty():
    rng = np.random.default_rng(2)
    both = _Both()
    t0 = both.submit("maxflow", _prob(rng))
    out = both.flush()                   # assignment queue empty
    assert sorted(out) == [t0] and bool(out[t0].converged)

    t1 = both.submit("assignment", rng.integers(0, 9, (4, 4)))
    out = both.flush()                   # maxflow queue empty
    assert sorted(out) == [t1] and bool(out[t1].converged)


def test_ticket_ordering_across_interleaved_rounds():
    """Tickets are globally monotonic across kinds AND flush rounds, and
    each flush returns exactly the tickets submitted since the last one."""
    rng = np.random.default_rng(3)
    both = _Both()
    seen: list[int] = []
    for _ in range(3):
        round_tickets = [
            both.submit("maxflow", _prob(rng)),
            both.submit("assignment", rng.integers(0, 9, (4, 4))),
            both.submit("matching", rng.random((4, 5)) < 0.5)]
        assert round_tickets == sorted(round_tickets)
        assert seen == [] or min(round_tickets) > max(seen)
        out = both.flush()
        assert sorted(out) == round_tickets
        seen += round_tickets
    assert seen == list(range(9))


# ---------------------------------------------------------- partial failure

def test_completed_kind_delivers_when_other_kind_fails(monkeypatch):
    """Max-flow solves first; if the assignment batch then raises, the
    max-flow results survive, delivered by the retry flush WITHOUT
    solving them again, and only assignment stays queued. The failure is
    injected through the registry, the engine's one dispatch seam."""
    rng = np.random.default_rng(4)
    engine = SolverEngine(device=CPU)
    pf, wa = _prob(rng), rng.integers(0, 9, (5, 5))
    tf = engine.submit("maxflow", pf)
    ta = engine.submit("assignment", wa)

    maxflow_calls = []
    real_maxflow = get_kind("maxflow")
    real_assignment = get_kind("assignment")

    def counting_maxflow(prep, **kw):
        maxflow_calls.append(prep)
        return real_maxflow.solve_prepared(prep, **kw)

    def assignment_boom(prep, **kw):
        raise RuntimeError("transient assignment failure")

    monkeypatch.setitem(kinds_mod._REGISTRY, "maxflow",
                        real_maxflow._replace(solve_prepared=counting_maxflow))
    monkeypatch.setitem(kinds_mod._REGISTRY, "assignment",
                        real_assignment._replace(
                            solve_prepared=assignment_boom))

    with pytest.raises(RuntimeError, match="transient"):
        engine.flush()
    # max-flow completed and left the queue; assignment stayed for retry
    assert engine.pending() == 1 and len(maxflow_calls) == 1

    monkeypatch.setitem(kinds_mod._REGISTRY, "assignment", real_assignment)
    out = engine.flush()
    # both tickets delivered; the max-flow batch was NOT solved again
    assert sorted(out) == [tf, ta] and len(maxflow_calls) == 1
    assert bool(out[tf].converged) and bool(out[ta].converged)
    jeng = jengine.SolverEngine()
    jt = [jeng.submit("maxflow", _jax("maxflow", pf)),
          jeng.submit("assignment", wa)]
    want = jeng.flush()
    assert_same(out[tf], want[jt[0]])
    assert_same(out[ta], want[jt[1]])


def test_submit_during_flush_is_never_dropped(monkeypatch):
    """A submit landing WHILE the batch solves (from a callback or another
    thread) stays queued for the next flush, and each flush returns a
    ticket-ordered dict of exactly its own round."""
    rng = np.random.default_rng(6)
    engine = SolverEngine(device=CPU)
    late: list[int] = []
    late_prob = _prob(rng)

    real = get_kind("maxflow")

    def submitting_solve(prep, **kw):
        if not late:                     # re-entrant submit, mid-flush
            late.append(engine.submit("maxflow", late_prob))
        return real.solve_prepared(prep, **kw)

    monkeypatch.setitem(kinds_mod._REGISTRY, "maxflow",
                        real._replace(solve_prepared=submitting_solve))

    t0 = engine.submit("maxflow", _prob(rng))
    out = engine.flush()
    # this round delivered only its own ticket...
    assert sorted(out) == [t0]
    # ...and the mid-flush submission survived for the next round
    assert engine.pending() == 1
    out2 = engine.flush()
    assert sorted(out2) == late
    assert bool(out2[late[0]].converged)
    jeng = jengine.SolverEngine()
    jt = jeng.submit("maxflow", _jax("maxflow", late_prob))
    assert_same(out2[late[0]], jeng.flush()[jt])


def test_flush_returns_ticket_ordered_dict():
    """Iteration order of a flush result is global ticket order even when
    kinds were submitted interleaved (kinds solve grouped, not in ticket
    order)."""
    rng = np.random.default_rng(7)
    both = _Both()
    tickets = [both.submit("maxflow", _prob(rng)),
               both.submit("assignment", rng.integers(0, 9, (4, 4))),
               both.submit("maxflow", _prob(rng)),
               both.submit("matching", rng.random((4, 5)) < 0.5)]
    out = both.flush()
    assert list(out) == sorted(tickets)


def test_flush_stats_out_reports_buckets():
    rng = np.random.default_rng(5)
    both = _Both()
    both.submit("maxflow", _prob(rng))
    both.submit("maxflow", _prob(rng))
    both.submit("assignment", rng.integers(0, 9, (4, 4)))
    both.submit("matching", rng.random((5, 5)) < 0.4)
    stats = []
    out = both.flush(stats_out=stats)
    assert len(out) == 4 and len(stats) == 3
    kinds = {s.kind: s for s in stats}
    assert kinds["maxflow"].n_real == 2
    assert kinds["assignment"].n_real == 1
    assert kinds["matching"].n_real == 1
    assert all(0.0 <= s.spread <= 1.0 for s in stats)


# ----------------------------------------------------- kinds and shims

def test_unknown_kind_raises_from_every_front_end():
    with pytest.raises(ValueError, match="registered kinds"):
        solve_batch("tsp", [object()], device=CPU)
    with pytest.raises(ValueError, match="registered kinds"):
        SolverEngine(device=CPU).submit("tsp", object())
    with pytest.raises(ValueError, match="registered kinds"):
        prepare_buckets("tsp", [object()])


def test_engine_deprecated_solver_kwargs_map_to_solver_kw():
    with pytest.warns(DeprecationWarning, match="maxflow_kw"):
        eng = SolverEngine(maxflow_kw={"backend": "xla"}, device=CPU)
    assert eng.solver_kw == {"maxflow": {"backend": "xla"}}
    with pytest.warns(DeprecationWarning, match="assignment_kw"):
        eng = SolverEngine(solver_kw={"matching": {"max_rounds": 5}},
                           assignment_kw={"alpha": 4}, device=CPU)
    assert eng.solver_kw == {"matching": {"max_rounds": 5},
                             "assignment": {"alpha": 4}}
    with pytest.warns(DeprecationWarning, match="assignment_kw"):
        jeng = jengine.SolverEngine(
            solver_kw={"matching": {"max_rounds": 5}},
            assignment_kw={"alpha": 4})
    assert eng.solver_kw == jeng.solver_kw


def test_engine_deprecated_submit_shims_delegate():
    rng = np.random.default_rng(0)
    p, w = _prob(rng), rng.integers(0, 9, (4, 4))
    eng = SolverEngine(device=CPU)
    with pytest.warns(DeprecationWarning, match="submit_maxflow"):
        t0 = eng.submit_maxflow(p)
    with pytest.warns(DeprecationWarning, match="submit_assignment"):
        t1 = eng.submit_assignment(w)
    out = eng.flush()
    assert sorted(out) == [t0, t1]
    assert bool(out[t0].converged) and bool(out[t1].converged)
    jeng = jengine.SolverEngine()
    jt = [jeng.submit("maxflow", _jax("maxflow", p)),
          jeng.submit("assignment", w)]
    want = jeng.flush()
    assert_same(out[t0], want[jt[0]])
    assert_same(out[t1], want[jt[1]])
    # the shims still validate (delegation, not a bypass)
    with pytest.warns(DeprecationWarning):
        with pytest.raises(ValueError, match="malformed assignment"):
            eng.submit_assignment(np.ones((3, 4)))


def test_engine_solves_on_the_card_unless_told(monkeypatch):
    """``device`` defaults to the card, raising without one; every kind
    solves on the engine's device, so ``solver_kw`` may name none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SolverEngine()
    eng = SolverEngine(device=CPU, solver_kw={"maxflow": {"backend": "xla"}})
    assert eng.kind_kw("maxflow") == {"backend": "xla",
                                      "device": torch.device(CPU)}
    assert eng.kind_kw("matching") == {"device": torch.device(CPU)}
    with pytest.raises(ValueError, match="device"):
        SolverEngine(device=CPU, solver_kw={"matching": {"device": CPU}})


# ------------------------------------------------------- matching kind

def test_sync_engine_serves_matching_with_zero_engine_changes():
    rng = np.random.default_rng(11)
    mesh = make_solver_mesh(2, device=CPU)
    engine = SolverEngine(mesh=mesh, device=CPU,
                          solver_kw={"matching": {"backend": "xla"}})
    adjs = [random_bipartite(rng, n, n) for n in (4, 6, 4)]
    tickets = [engine.submit("matching", a) for a in adjs]
    # edge-list payloads canonicalize through the registered validator
    edge = (np.array([[0, 1], [1, 0]]), (2, 2))
    t_edge = engine.submit("matching", edge)
    out = engine.flush()
    assert sorted(out) == tickets + [t_edge]
    base = solve_batch("matching", adjs, mesh=mesh, device=CPU)
    for t, b in zip(tickets, base):
        assert_same(out[t], b)
    assert int(out[t_edge].cardinality) == 2
    # the reference's unsharded flush of the same queue (its mesh path
    # fails under jax 0.9.0, ROADMAP F1; lanes never change a result)
    jeng = jengine.SolverEngine(solver_kw={"matching": {"backend": "xla"}})
    for a in adjs:
        jeng.submit("matching", a)
    jeng.submit("matching", edge)
    want = jeng.flush()
    for t in out:
        assert_same(out[t], want[t])


def test_matching_validator_rejects_before_a_ticket():
    with pytest.raises(ValueError, match="0/1"):
        validate_matching_problem(np.array([[0, 2], [1, 0]]))
    engine = SolverEngine(device=CPU)
    with pytest.raises(ValueError, match="malformed matching"):
        engine.submit("matching", np.array([[0, 2], [1, 0]]))
    assert engine.pending() == 0


# ------------------------------------------------------ compact engine

@pytest.mark.parametrize("n_lanes", [1, 2])
def test_engine_compact_matches_direct_front_end(n_lanes):
    """A compacting engine returns exactly what the direct batch calls do
    (on ``n_lanes`` CPU lanes), and what the reference's engine does."""
    mesh = None if n_lanes == 1 else make_solver_mesh(n_lanes, device=CPU)
    engine = SolverEngine(mesh=mesh, bucket="max", compact=True,
                          device=CPU)
    rng = np.random.default_rng(7)
    probs = [GridProblem(*random_grid_problem(rng, h, w))
             for h, w in [(6, 6), (4, 5), (6, 6)]]
    ws = [rng.integers(0, 50, (n, n)) for n in (5, 7)]
    tickets = [engine.submit("maxflow", p) for p in probs]
    tickets += [engine.submit("assignment", w) for w in ws]
    out = engine.flush()
    assert sorted(out) == tickets and engine.pending() == 0

    base_f = solve_batch("maxflow", probs, bucket="max", mesh=mesh,
                         device=CPU)
    base_a = solve_batch("assignment", ws, bucket="max", mesh=mesh,
                         device=CPU)
    for t, b in zip(tickets, base_f + base_a):
        assert_same(out[t], b)
    jeng = jengine.SolverEngine(bucket="max", compact=True)
    for p in probs:
        jeng.submit("maxflow", _jax("maxflow", p))
    for w in ws:
        jeng.submit("assignment", w)
    want = jeng.flush()
    for t in tickets:
        assert_same(out[t], want[t])


def test_compact_engine_with_lanes_pads_like_the_front_end():
    """A lane count that does not divide the bucket pads it with inert
    instances, as the front end does."""
    mesh = make_solver_mesh(3, device=CPU)
    rng = np.random.default_rng(8)
    probs = [_prob(rng) for _ in range(4)]
    engine = SolverEngine(mesh=mesh, compact=True, device=CPU)
    ts = [engine.submit("maxflow", p) for p in probs]
    stats = []
    out = engine.flush(stats_out=stats)
    assert [s.n_pad for s in stats] == [2]
    want = solve_batch("maxflow", probs, device=CPU)
    for t, w in zip(ts, want):
        assert_same(out[t], w)


# ------------------------------------------------------- warm re-solve

def _mf_ref(p) -> float:
    return maxflow_grid_ref(np.asarray(p.cap_nbr), np.asarray(p.cap_src),
                            np.asarray(p.cap_sink))


def test_engine_submit_base_delta_and_metrics():
    rng = np.random.default_rng(11)
    p = _prob(rng, 5, 5)
    m, jm = SchedulerMetrics(), jmetrics.SchedulerMetrics()
    eng = SolverEngine(metrics=m, device=CPU)
    jeng = jengine.SolverEngine(metrics=jm)
    t1 = eng.submit("maxflow", p)
    assert jeng.submit("maxflow", _jax("maxflow", p)) == t1
    assert_same(eng.flush()[t1], jeng.flush()[t1])
    d = GraphDelta(idx=(np.array([3]), np.array([2]), np.array([2])),
                   values=np.array([9.0], np.float32), field="cap_nbr")
    t2 = eng.submit("maxflow", base=t1, delta=d)
    assert jeng.submit("maxflow", base=t1,
                       delta=jwarm.GraphDelta(*d)) == t2
    r2 = eng.flush()[t2]
    assert_same(r2, jeng.flush()[t2])
    assert abs(float(r2.flow) - _mf_ref(apply_delta("maxflow", p, d))) < 1e-4
    snap = m.snapshot()["warm"]
    assert snap["cache_hits"] == 1 and snap["warm_solves"] == 1
    assert snap["warm_fraction"] == 0.5        # one warm, one cold so far
    assert snap == jm.snapshot()["warm"]
    # base by cache key; unknown base raises KeyError (caller retries cold)
    key = eng.cache.key("maxflow", p)
    t3 = eng.submit("maxflow", base=key, delta=d)
    assert_same(eng.flush()[t3], r2)
    with pytest.raises(KeyError):
        eng.submit("maxflow", base=10_000, delta=d)
    with pytest.raises(ValueError, match="base="):
        eng.submit("maxflow", delta=d)
