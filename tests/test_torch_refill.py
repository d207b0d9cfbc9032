"""Continuous batching (``RefillSolver``): the port against the JAX package.

For every registered kind, a session seeded with some requests and fed
the rest through ``admit`` delivers, for every request, exactly the
result (values and counters) of the same request in a closed batch padded
to the session's shape: the port's masked and compacted ``solve_batch``
and the JAX package's ``RefillSolver`` and ``solve_batch``, at capacity
1, 2 and 4. Also checked: empty seed slots are offered before cycle 0, a
decline is re-offered while anything is live, results arrive in
convergence order, the ``admit`` contract, a bad admission fails alone,
that device lanes (ROADMAP M7) and warm seeds and admissions (M6) give
the closed batch's and ``solve_warm``'s results, and that a traced
session (M8) records the reference's spans and gives the untraced bits.
Tolerance: exact equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import assert_same

import repro.core.batch as jbatch
import repro.core.refill as jrefill
import repro_torch.core.kinds as kinds_mod
from repro_torch.core.assignment.ref import optimal_weight
from repro_torch.core.batch import solve_batch
from repro_torch.core.matching.ref import random_bipartite
from repro_torch.core.maxflow.grid import GridProblem
from repro_torch.core.maxflow.ref import random_grid_problem
from repro_torch.core.kinds import get_kind
from repro_torch.core.refill import RefillSolver, refill_runtime
from repro_torch.core.warm import WarmStart, solve_warm
from repro_torch.launch.mesh import make_solver_mesh
from repro_torch.obs import Tracer

CPU = "cpu"


def _grid(rng, h, w, easy=False):
    cap, cs, ct = random_grid_problem(rng, h, w)
    if easy:
        cs = np.minimum(cs, 1.0)
    return GridProblem(cap, cs, ct)


def _jax(kind, payloads):
    if kind == "maxflow":
        return [jbatch.GridProblem(*map(jnp.asarray, p)) for p in payloads]
    return payloads


def _queue_admit(queue, chunk=None):
    """An ``admit`` callback popping up to ``chunk`` payloads per offer."""
    def admit(n_free):
        take = n_free if chunk is None else min(chunk, n_free)
        out, queue[:take] = list(queue[:take]), []
        return out
    return admit


def _kind_cases(seed):
    """(kind, shape, payloads) per kind: ragged sizes and difficulty, and
    a born-dead instance where the kind can express one."""
    rng = np.random.default_rng(seed)
    probs = [_grid(rng, 8, 8), _grid(rng, 5, 7, easy=True), _grid(rng, 8, 8),
             _grid(rng, 6, 6, easy=True), _grid(rng, 8, 8, easy=True),
             _grid(rng, 7, 5)]
    ws = [rng.integers(0, 50, (n, n)) for n in (6, 4, 6, 5, 3, 6)]
    adjs = [random_bipartite(rng, 7, 9, 0.25) for _ in range(5)]
    adjs.append(np.zeros((3, 4), bool))          # born-dead: no edges
    return [("maxflow", (8, 8), probs), ("assignment", (6,), ws),
            ("matching", (7, 9), adjs)]


@pytest.mark.parametrize("capacity", [1, 2, 4])
def test_refill_equals_closed_batch_and_jax(capacity):
    """Seed ``capacity`` requests, admit the rest one per offer: every
    result equals the closed batch (masked, compacted, and the JAX
    package's) and the JAX package's refill session."""
    for kind, shape, payloads in _kind_cases(0):
        seed_n = min(capacity, len(payloads))
        queue = list(payloads[seed_n:])
        got = RefillSolver(kind, shape=shape, capacity=capacity,
                           device=CPU).run(payloads[:seed_n],
                                           admit=_queue_admit(queue, 1))
        assert not queue and sorted(got) == list(range(len(payloads)))
        jpay = _jax(kind, payloads)
        jqueue = list(jpay[seed_n:])
        want_refill = jrefill.RefillSolver(
            kind, shape=shape, capacity=capacity).run(
                jpay[:seed_n], admit=_queue_admit(jqueue, 1))
        masked = solve_batch(kind, payloads, bucket="max", device=CPU)
        compacted = solve_batch(kind, payloads, bucket="max", compact=True,
                                device=CPU)
        want = jbatch.solve_batch(kind, jpay, bucket="max")
        for i in range(len(payloads)):
            assert_same(got[i], want_refill[i])
            assert_same(got[i], want[i])
            assert_same(got[i], masked[i])
            assert_same(got[i], compacted[i])


@pytest.mark.parametrize("kind", ["maxflow", "assignment", "matching"])
def test_refill_on_the_kernel_backend_equals_jax(kind):
    """``backend="pallas"``: K1/K3, K4 or K5's plain versions on the CPU,
    the JAX package's kernels in interpret mode."""
    _, shape, payloads = next(c for c in _kind_cases(1) if c[0] == kind)
    queue = list(payloads[2:])
    got = RefillSolver(kind, shape=shape, capacity=2, backend="pallas",
                       device=CPU).run(payloads[:2], admit=_queue_admit(queue))
    want = jbatch.solve_batch(kind, _jax(kind, payloads), bucket="max",
                              backend="pallas")
    for i in range(len(payloads)):
        assert_same(got[i], want[i])


def test_underseeded_session_offers_free_slots_before_cycle_zero():
    rng = np.random.default_rng(2)
    ws = [rng.integers(0, 50, (5, 5)) for _ in range(4)]
    offers = []
    ws_left = list(ws[1:])

    def admit(n_free):
        offers.append(n_free)
        out, ws_left[:] = list(ws_left), []
        return out[:n_free]

    got = RefillSolver("assignment", shape=(5,), capacity=4,
                       device=CPU).run(ws[:1], admit=admit)
    assert offers[0] == 3, "empty seed slots not offered before cycle 0"
    want = jbatch.solve_batch("assignment", ws, bucket="max")
    for i, w in enumerate(ws):
        assert int(got[i].weight) == optimal_weight(w)
        assert_same(got[i], want[i])


def test_decline_then_admit_is_reoffered():
    """While anything is live, a declined offer comes back at every later
    cycle boundary."""
    rng = np.random.default_rng(3)
    hard = _grid(rng, 12, 12)
    easies = [_grid(rng, 8, 8, easy=True) for _ in range(2)]
    probs = [hard, easies[0], easies[1]]
    kw = {"rounds_per_heuristic": 8}
    want = solve_batch("maxflow", probs, bucket="max", device=CPU, **kw)
    assert int(want[0].rounds) >= int(want[1].rounds) + 3 * 8, \
        "hard seed not hard enough: re-offer path untested"
    calls = {"n": 0}
    queue = [easies[1]]

    def admit(n_free):
        calls["n"] += 1
        if calls["n"] < 3:                       # decline twice
            return []
        out, queue[:] = list(queue), []
        return out[:n_free]

    got = RefillSolver("maxflow", shape=(12, 12), capacity=2, device=CPU,
                       **kw).run([hard, easies[0]], admit=admit)
    assert calls["n"] >= 3 and not queue
    for i in range(3):
        assert_same(got[i], want[i])
    jwant = jbatch.solve_batch("maxflow", _jax("maxflow", probs),
                               bucket="max", **kw)
    for i in range(3):
        assert_same(got[i], jwant[i])


def test_results_arrive_in_convergence_order():
    rng = np.random.default_rng(4)
    hard, easy = _grid(rng, 8, 8), _grid(rng, 8, 8, easy=True)
    r_hard, r_easy = solve_batch("maxflow", [hard, easy], bucket="max",
                                 device=CPU)
    assert int(r_hard.rounds) > int(r_easy.rounds), "stream not ragged"
    order = []
    RefillSolver("maxflow", shape=(8, 8), capacity=2, device=CPU).run(
        [hard, easy], on_result=lambda i, r: order.append(i))
    assert order == [1, 0], f"delivery order {order} is not convergence order"


def test_admit_contract():
    rng = np.random.default_rng(6)
    ws = [rng.integers(0, 50, (4, 4)) for _ in range(3)]
    with pytest.raises(ValueError, match="capacity"):
        RefillSolver("assignment", shape=(4,), capacity=0, device=CPU)
    with pytest.raises(ValueError, match="initial payloads"):
        RefillSolver("assignment", shape=(4,), capacity=2,
                     device=CPU).run(ws)
    with pytest.raises(ValueError, match="at most n_free"):
        RefillSolver("assignment", shape=(4,), capacity=1, device=CPU).run(
            ws[:1], admit=lambda n: ws)          # over-returns
    s = RefillSolver("assignment", shape=(4,), capacity=1, device=CPU)
    assert s.fits(ws[0]) and not s.fits(rng.integers(0, 5, (6, 6)))
    real = kinds_mod.get_kind("maxflow")
    kinds_mod._REGISTRY["maxflow"] = real._replace(refill=None)
    try:
        with pytest.raises(ValueError, match="no refill runtime"):
            refill_runtime("maxflow", device=CPU)
    finally:
        kinds_mod._REGISTRY["maxflow"] = real


def test_bad_admission_fails_alone():
    """A payload that fails validation at admission reports through
    ``on_error`` with its own request index; the others still match."""
    rng = np.random.default_rng(7)
    ws = [rng.integers(0, 50, (5, 5)) for _ in range(3)]
    bad = np.ones((5, 5))                        # float: validator rejects
    too_big = rng.integers(0, 50, (7, 7))        # does not fit the bucket
    queue = [ws[1], bad, too_big, ws[2]]
    errors = []
    got = RefillSolver("assignment", shape=(5,), capacity=1,
                       device=CPU).run(ws[:1], admit=_queue_admit(queue, 1),
                                       on_error=lambda i, e:
                                       errors.append((i, e)))
    assert [i for i, _ in errors] == [2, 3]      # arrival indices
    assert all(isinstance(e, ValueError) for _, e in errors)
    want = jbatch.solve_batch("assignment", ws, bucket="max")
    for got_i, want_i in zip((got[0], got[1], got[4]), want):
        assert_same(got_i, want_i)
    with pytest.raises(ValueError, match="malformed assignment"):
        RefillSolver("assignment", shape=(5,), capacity=1, device=CPU).run(
            ws[:1], admit=_queue_admit([bad], 1))


def test_unported_options_raise_naming_their_items():
    # The name predates M8: device lanes (M7), warm starts (M6) and span
    # tracing (M8) are all ported now, and the options that once raised
    # naming them are held to the ported behaviour.
    rng = np.random.default_rng(8)
    ws = [rng.integers(0, 50, (4, 4)) for _ in range(2)]
    closed = solve_batch("assignment", ws, bucket="max", device=CPU)
    tr = Tracer()
    traced = RefillSolver("assignment", shape=(4,), capacity=2, tracer=tr,
                          device=CPU).run(ws)
    untraced = RefillSolver("assignment", shape=(4,), capacity=2,
                            device=CPU).run(ws)
    for i in range(2):
        assert_same(traced[i], untraced[i])
        assert_same(traced[i], closed[i])
    names = [s.name for s in tr.spans()]
    assert names == ["bucket/pad", "bucket/pad", "device-solve"]
    got = RefillSolver("assignment", shape=(4,), capacity=2, device=CPU,
                       mesh=make_solver_mesh(2, device=CPU)).run(ws)
    for i in range(2):
        assert_same(got[i], closed[i])
    sol = get_kind("assignment").solution_of(closed[0])
    warm = WarmStart(sol, base_problem=ws[0])
    s = RefillSolver("assignment", shape=(4,), capacity=1, device=CPU)
    want = solve_warm("assignment", ws[1:], {0: warm}, device=CPU)[0]
    assert_same(s.run(ws[1:], warm={0: warm})[0], want)
    got = s.run(ws[:1], admit=_queue_admit([(ws[1], warm)]))
    assert_same(got[0], closed[0])
    assert_same(got[1], want)
    # an edge-list matching payload is a 2-tuple too, and no warm pair
    edges = (np.array([[0, 1], [1, 0]]), (2, 2))
    got = RefillSolver("matching", shape=(2, 2), capacity=1,
                       device=CPU).run([], admit=_queue_admit([edges]))
    assert int(got[0].cardinality) == 2
