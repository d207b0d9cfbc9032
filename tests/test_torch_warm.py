"""Warm start (``repro_torch.core.warm``): the port against the JAX package.

The cases of ``tests/test_warm.py`` (the reference's own warm tests),
each run on the port AND held leaf for leaf, dtypes and counters
included, to the JAX package's result on the same numpy inputs:

* warm == cold optimum over chained delta sequences (each step starts
  from the previous step's solution), for every maxflow backend
  (``xla``, ``multipush``, ``pallas``, ``balanced``), both assignment
  methods on both backends and matching on both backends; flows against
  scipy, weights against the Hungarian optimum, cardinalities against
  Hopcroft-Karp, and the height invariant on the fixed-cadence backends;
* warm without a base problem;
* masked == compacted == refill on a mixed warm and cold batch, and
  refill admitting ``(payload, WarmStart)`` pairs mid-solve, per kind;
* ``GraphDelta`` forms, ``delta_bound``, ``content_key`` (the reference's
  digest, for numpy and tensor leaves);
* ``SolutionCache``'s LRU order, budgets, spill and reload;
* the warm state itself (``build_warm_state``) against the reference's,
  the assignment ladder's first rung for large ``delta_bound`` (above
  ``2 ** 30 / (2 (m + 1))`` too) and ``None``, and the leaf order of the
  port's tree flattener against ``jax.tree.leaves``.

Fixed seed sweeps stand in for the reference's Hypothesis properties.
Pallas kernels run as the JAX package's own tests run them on the CPU
(interpret mode), the port's kernels as their plain versions.
Tolerance: exact equality (``assert_same``); the instances are
integer-valued.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same

import repro.core.batch as jb
import repro.core.refill as jrefill
import repro.core.warm as jw
from repro.core.kinds import get_kind as jget_kind
from repro_torch.core import warm as tw
from repro_torch.core.assignment.ref import optimal_weight
from repro_torch.core.batch import solve_batch
from repro_torch.core.kinds import get_kind
from repro_torch.core.masking import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.core.matching.ref import hopcroft_karp, random_bipartite
from repro_torch.core.maxflow.grid import GridProblem, check_no_violations
from repro_torch.core.maxflow.ref import maxflow_grid_ref, random_grid_problem
from repro_torch.core.refill import RefillSolver
from repro_torch.interop import to_numpy

CPU = "cpu"
KINDS = ["maxflow", "assignment", "matching"]


def _grid(rng, H=6, W=7) -> GridProblem:
    return GridProblem(*random_grid_problem(rng, H, W))


def _mf_ref(p) -> float:
    return maxflow_grid_ref(*(np.asarray(a) for a in p))


def _mutate_grid(rng, p, n_edits=4) -> GridProblem:
    """The reference test's delta: bump interior arcs, jitter the sink."""
    cap = np.asarray(p.cap_nbr).copy()
    H, W = cap.shape[-2:]
    for _ in range(n_edits):
        d, y, x = rng.integers(4), rng.integers(H), rng.integers(W)
        if cap[d, y, x] > 0:      # keep off-grid arcs at zero (well-formed)
            cap[d, y, x] = max(0.0, cap[d, y, x] + rng.integers(-4, 5))
    ct = np.maximum(np.asarray(p.cap_sink)
                    + rng.integers(-2, 3, (H, W)), 0.0)
    return GridProblem(cap.astype(np.float32), np.asarray(p.cap_src),
                       ct.astype(np.float32))


def _mutate_w(rng, w, n_edits=3):
    w2 = np.asarray(w).copy()
    n = w2.shape[0]
    for _ in range(n_edits):
        i, j = rng.integers(n), rng.integers(n)
        w2[i, j] = max(0, w2[i, j] + rng.integers(-3, 4))
    return w2


def _mutate_adj(rng, adj, n_edits=4):
    a = np.asarray(adj).copy()
    nl, nr = a.shape
    for _ in range(n_edits):
        a[rng.integers(nl), rng.integers(nr)] ^= True
    return a


def _jax(kind, payload):
    """The JAX package's form of a port payload."""
    if payload is None:
        return None
    if kind == "maxflow":
        return jb.GridProblem(*(jnp.asarray(np.asarray(a)) for a in payload))
    return np.asarray(payload)


def _jax_ws(kind, ws: tw.WarmStart) -> jw.WarmStart:
    """The JAX package's ``WarmStart`` carrying the same solution."""
    return jw.WarmStart({k: np.asarray(to_numpy(v))
                         for k, v in ws.solution.items()},
                        base_problem=_jax(kind, ws.base_problem),
                        delta_bound=ws.delta_bound)


def _solve_warm_both(kind, payloads, warm, stats_out=None, **kw):
    """The port's ``solve_warm`` and the JAX package's on the same inputs,
    held equal leaf for leaf and ``BucketStats`` for ``BucketStats``;
    returns the port's results (its stats go to ``stats_out``)."""
    stats_t, stats_j = [], []
    got = tw.solve_warm(kind, payloads, warm, device=CPU,
                        stats_out=stats_t, **kw)
    want = jw.solve_warm(kind, [_jax(kind, p) for p in payloads],
                         {i: _jax_ws(kind, ws) for i, ws in warm.items()},
                         stats_out=stats_j, **kw)
    for g, w in zip(got, want):
        assert_same(g, w)
    assert [tuple(s) for s in stats_t] == [tuple(s) for s in stats_j]
    if stats_out is not None:
        stats_out += stats_t
    return got


def _cold_both(kind, payloads, **kw):
    got = solve_batch(kind, payloads, device=CPU, **kw)
    want = jb.solve_batch(kind, [_jax(kind, p) for p in payloads], **kw)
    for g, w in zip(got, want):
        assert_same(g, w)
    return got


# ------------------------------------------------- per-kind equivalence


@pytest.mark.parametrize("backend", ["xla", "multipush", "pallas",
                                     "balanced"])
def test_maxflow_warm_equals_cold_over_delta_sequence(backend):
    """Chained deltas: each step warm-starts from the previous solution,
    equals the JAX package's warm solve and the cold flow of its own
    mutated graph."""
    rng = np.random.default_rng(0)
    kind = get_kind("maxflow")
    p = _grid(rng)
    sol, base = None, None
    for step in range(5):
        if step:
            p = _mutate_grid(rng, base)
        cold = _cold_both("maxflow", [p], backend=backend)[0]
        res = (_solve_warm_both("maxflow", [p], {0: tw.WarmStart(
            sol, base_problem=base)}, backend=backend)[0] if sol else cold)
        assert float(res.flow) == float(cold.flow) == _mf_ref(p), step
        if backend != "balanced":   # ROADMAP §3: the balanced quirk
            assert bool(check_no_violations(res.state)), step
        sol, base = kind.solution_of(res), p


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("method", ["auction", "pushrelabel"])
def test_assignment_warm_equals_cold_over_delta_sequence(method, backend):
    rng = np.random.default_rng(1)
    kind = get_kind("assignment")
    kw = dict(method=method, backend=backend)
    w = rng.integers(0, 20, (6, 6)).astype(np.int32)
    sol, base = None, None
    for step in range(5):
        if step:
            w = _mutate_w(rng, base)
        res = (_solve_warm_both("assignment", [w], {0: tw.WarmStart(
            sol, base_problem=base)}, **kw)[0] if sol
            else _cold_both("assignment", [w], **kw)[0])
        assert int(res.weight) == optimal_weight(w), step
        assert bool(res.converged), step
        sol, base = kind.solution_of(res), w


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_matching_warm_equals_cold_over_delta_sequence(backend):
    rng = np.random.default_rng(2)
    kind = get_kind("matching")
    adj = random_bipartite(rng, 8, 7, p=0.3)
    sol, base = None, None
    for step in range(5):
        if step:
            adj = _mutate_adj(rng, base)
        res = (_solve_warm_both("matching", [adj], {0: tw.WarmStart(
            sol, base_problem=base)}, backend=backend)[0] if sol
            else _cold_both("matching", [adj], backend=backend)[0])
        assert int(res.cardinality) == hopcroft_karp(adj)[2], step
        mr = to_numpy(res.match_row)
        matched = mr >= 0
        # the warm result is a VALID matching of the mutated graph
        assert adj[matched, mr[matched]].all(), step
        assert len(set(mr[matched])) == matched.sum(), step
        sol, base = kind.solution_of(res), adj


def test_warm_without_base_problem_still_correct():
    """No base problem: maxflow falls back to a cold per-instance init,
    assignment re-enters at the cold rung with the prices, matching keeps
    the surviving pairs; every one equals the JAX package's."""
    rng = np.random.default_rng(3)
    p = _grid(rng)
    sol = get_kind("maxflow").solution_of(
        solve_batch("maxflow", [p], device=CPU)[0])
    p2 = _mutate_grid(rng, p)
    res = _solve_warm_both("maxflow", [p2], {0: tw.WarmStart(sol)})[0]
    assert float(res.flow) == _mf_ref(p2)
    assert_same(res, solve_batch("maxflow", [p2], device=CPU)[0])

    w = rng.integers(0, 15, (5, 5)).astype(np.int32)
    sol = get_kind("assignment").solution_of(
        solve_batch("assignment", [w], device=CPU)[0])
    w2 = _mutate_w(rng, w)
    res = _solve_warm_both("assignment", [w2], {0: tw.WarmStart(sol)})[0]
    assert int(res.weight) == optimal_weight(w2)

    adj = random_bipartite(rng, 9, 8, p=0.3)
    sol = get_kind("matching").solution_of(
        solve_batch("matching", [adj], device=CPU)[0])
    adj2 = _mutate_adj(rng, adj)
    res = _solve_warm_both("matching", [adj2], {0: tw.WarmStart(sol)})[0]
    assert int(res.cardinality) == hopcroft_karp(adj2)[2]


@pytest.mark.parametrize("seed", range(8))
def test_fixed_seed_warm_equivalence_sweep(seed):
    """The reference's two Hypothesis properties as a fixed seed sweep
    over the same delta space: maxflow on 5 x 6 grids with 1-8 edits and
    assignment on 5 x 5 weights with 1-6 edits."""
    rng = np.random.default_rng(seed)
    p = _grid(rng, 5, 6)
    res = solve_batch("maxflow", [p], device=CPU)[0]
    p2 = _mutate_grid(rng, p, n_edits=1 + seed % 8)
    warm = _solve_warm_both("maxflow", [p2], {0: tw.WarmStart(
        get_kind("maxflow").solution_of(res), base_problem=p)})[0]
    assert float(warm.flow) == _mf_ref(p2)
    assert bool(check_no_violations(warm.state))

    w = rng.integers(0, 25, (5, 5)).astype(np.int32)
    res = solve_batch("assignment", [w], device=CPU)[0]
    w2 = _mutate_w(rng, w, n_edits=1 + seed % 6)
    warm = _solve_warm_both("assignment", [w2], {0: tw.WarmStart(
        get_kind("assignment").solution_of(res), base_problem=w)})[0]
    assert int(warm.weight) == optimal_weight(w2)


# ------------------------------------------------- drivers agree


def _mixed_batch(kind, seed):
    """Four bases, their solutions, the mutated payloads and warm starts
    at positions 0 and 2 (a mixed warm/cold batch); session shape."""
    rng = np.random.default_rng(seed)
    if kind == "maxflow":
        bases = [_grid(rng) for _ in range(4)]
        mutated = [_mutate_grid(rng, b) for b in bases]
        shape = (6, 7)
    elif kind == "assignment":
        bases = [rng.integers(0, 30, (6, 6)) for _ in range(4)]
        mutated = [_mutate_w(rng, b) for b in bases]
        shape = (6,)
    else:
        bases = [random_bipartite(rng, 8, 7, 0.3) for _ in range(4)]
        mutated = [_mutate_adj(rng, b) for b in bases]
        shape = (8, 7)
    k = get_kind(kind)
    sols = [k.solution_of(r) for r in solve_batch(kind, bases, device=CPU)]
    warm = {i: tw.WarmStart(sols[i], base_problem=bases[i]) for i in (0, 2)}
    return bases, sols, mutated, warm, shape


@pytest.mark.parametrize("kind", KINDS)
def test_masked_compacted_refill_agree_on_warm_batch(kind):
    _, _, mutated, warm, shape = _mixed_batch(kind, 4)
    stats_m, stats_c = [], []
    masked = _solve_warm_both(kind, mutated, warm, stats_out=stats_m)
    compacted = _solve_warm_both(kind, mutated, warm, compact=True,
                                 stats_out=stats_c)
    refill = RefillSolver(kind, shape=shape, capacity=4, device=CPU).run(
        mutated, warm=warm)
    jrefill_out = jrefill.RefillSolver(kind, shape=shape, capacity=4).run(
        [_jax(kind, p) for p in mutated],
        warm={i: _jax_ws(kind, ws) for i, ws in warm.items()})
    for i in range(len(mutated)):
        assert_same(masked[i], compacted[i])
        assert_same(masked[i], refill[i])
        assert_same(refill[i], jrefill_out[i])
    assert [s._replace(compact=False) for s in stats_c] == stats_m
    # the same queue through solve_batch(warm=) is solve_warm
    via_batch = solve_batch(kind, mutated, warm=warm, device=CPU)
    for a, b in zip(via_batch, masked):
        assert_same(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_refill_admits_warm_pairs_mid_solve(kind):
    bases, sols, mutated, _, shape = _mixed_batch(kind, 5)
    items = [(mutated[1], tw.WarmStart(sols[1], base_problem=bases[1])),
             mutated[2]]
    jitems = [(_jax(kind, mutated[1]), _jax_ws(kind, items[0][1])),
              _jax(kind, mutated[2])]

    def feeder(queue):
        def admit(n_free):
            out, queue[:n_free] = list(queue[:n_free]), []
            return out
        return admit

    got = RefillSolver(kind, shape=shape, capacity=2, device=CPU).run(
        [mutated[0]], admit=feeder(list(items)))
    want = jrefill.RefillSolver(kind, shape=shape, capacity=2).run(
        [_jax(kind, mutated[0])], admit=feeder(list(jitems)))
    assert sorted(got) == [0, 1, 2]
    for i in range(3):
        assert_same(got[i], want[i])
    warm_alone = tw.solve_warm(kind, [mutated[1]], {0: items[0][1]},
                               device=CPU)[0]
    assert_same(got[1], warm_alone)


def test_refill_warm_errors():
    w = np.random.default_rng(6).integers(0, 9, (4, 4))
    s = RefillSolver("assignment", shape=(4,), capacity=1, device=CPU)
    with pytest.raises(ValueError, match="out of range"):
        s.run([w], warm={1: tw.WarmStart({"p_y": np.zeros(4, np.int32)})})


# ------------------------------------------------- the warm state itself


def _warm_state_both(kind, payload, ws, bshape, **kw):
    """``build_warm_state`` of one instance in both packages."""
    k, jk = get_kind(kind), jget_kind(kind)
    rt, jrt = k.refill(device=CPU, **kw), jk.refill(**kw)
    p = k.validate(payload)
    jp = jk.validate(_jax(kind, payload))
    got = tw.build_warm_state(k, rt, k.warm_state(device=CPU, **kw),
                              rt.pad_one(p, bshape), p, ws, bshape)
    want = jw.build_warm_state(jk, jrt, jk.warm_state(**kw),
                               jrt.pad_one(jp, bshape), jp,
                               _jax_ws(kind, ws), bshape)
    return got, want


@pytest.mark.parametrize("kind", KINDS)
def test_warm_state_equals_reference(kind):
    """The warm state (padded to a larger bucket, with and without a base
    problem) equals the reference's leaf for leaf, the grid's internal
    ``(4, B, H, W)`` cap included."""
    bases, sols, mutated, _, shape = _mixed_batch(kind, 7)
    bshape = tuple(s + 2 for s in shape)
    for i in range(4):
        for base in (bases[i], None):
            ws = tw.WarmStart(sols[i], base_problem=base)
            got, want = _warm_state_both(kind, mutated[i], ws, bshape)
            assert_same(got, want)


def test_grid_warm_repairs_deficits_and_keeps_heights_in_range():
    """Shrunken capacities leave deficits: the repair loop restores
    ``e >= 0`` and the heights are a fresh BFS (every height in [1, N])."""
    rng = np.random.default_rng(8)
    p = _grid(rng, 8, 8)
    sol = get_kind("maxflow").solution_of(
        solve_batch("maxflow", [p], device=CPU)[0])
    cut = GridProblem(np.floor(p.cap_nbr / 3).astype(np.float32), p.cap_src,
                      np.floor(p.cap_sink / 3).astype(np.float32))
    got, want = _warm_state_both("maxflow", cut, tw.WarmStart(
        sol, base_problem=p), (8, 8))
    assert_same(got, want)
    n_nodes = 8 * 8 + 2
    assert bool((got.e >= 0).all())
    assert int(got.h.min()) >= 1 and int(got.h.max()) <= n_nodes
    res = tw.solve_warm("maxflow", [cut], {0: tw.WarmStart(
        sol, base_problem=p)}, device=CPU)[0]
    assert float(res.flow) == _mf_ref(cut)


@pytest.mark.parametrize("bound", ["none", "computed", 0.0, 0.5, 1.0, 7.0,
                                   1e3, 2 ** 30 / 14 - 1, 2 ** 30 / 14,
                                   2 ** 30 / 14 + 1, 2 ** 29, 1e12])
def test_assignment_ladder_first_rung(bound):
    """The warm ε rung for ``m = 6`` weights below 10**6 (a cold first
    rung near 7 * 10**5): ``(m+1)·2·ceil(Δ)`` passes ``2 ** 30`` just
    above ``2 ** 30 / 14`` and is capped there; ``"none"`` (no base, no
    bound) re-enters at ``2 ** 30``, which clamps to the cold rung, and
    ``"computed"`` takes ``delta_bound`` from the base. The port's first
    rung, warm state and result equal the reference's for each."""
    rng = np.random.default_rng(9)
    w = rng.integers(0, 10 ** 6, (6, 6))
    res = solve_batch("assignment", [w], device=CPU)[0]
    w2 = _mutate_w(rng, w)
    sol = get_kind("assignment").solution_of(res)
    if bound == "none":
        ws, d = tw.WarmStart(sol), 2 ** 30
    else:
        ws = tw.WarmStart(sol, base_problem=w,
                          delta_bound=None if bound == "computed" else bound)
        b = tw.delta_bound(w2, w) if bound == "computed" else bound
        d = min(2 ** 30, 7 * 2 * int(np.ceil(b)))
    got, want = _warm_state_both("assignment", w2, ws, (6,))
    assert_same(got, want)
    wp = w2.astype(np.int64) + 1 - min(0, int(w2.min()))   # bonus-padded
    eps_cold = max(1, -(-np.abs(-(6 + 1) * wp).max() // 10))
    assert int(got.eps[0]) == min(1 + d, eps_cold)
    out = _solve_warm_both("assignment", [w2], {0: ws})[0]
    assert int(out.weight) == optimal_weight(w2)


# ------------------------------------------------- delta + cache units


def test_graph_delta_field_and_dense_forms():
    rng = np.random.default_rng(7)
    p = _grid(rng)
    d = tw.GraphDelta(idx=(np.array([3]), np.array([2]), np.array([2])),
                      values=np.array([9.0], np.float32), field="cap_nbr")
    p2 = tw.apply_delta("maxflow", p, d)
    assert float(p2.cap_nbr[3, 2, 2]) == 9.0
    assert float(p.cap_nbr[3, 2, 2]) != 9.0        # never aliased
    jd = jw.GraphDelta(*d)
    assert_same(tuple(p2), tuple(np.asarray(a) for a in jw.apply_delta(
        "maxflow", _jax("maxflow", p), jd)))
    w = rng.integers(0, 9, (4, 4)).astype(np.int32)
    d = tw.GraphDelta(idx=(np.array([1]), np.array([2])),
                      values=np.array([7], np.int32))
    w_before = w.copy()
    w2 = tw.apply_delta("assignment", w, d)
    assert w2[1, 2] == 7 and np.array_equal(w, w_before)
    assert_same(w2, jw.apply_delta("assignment", w, jw.GraphDelta(*d)))
    # a delta sequence applies in order
    seq = [tw.GraphDelta(idx=(np.array([0]), np.array([0])),
                         values=np.array([5], np.int32)),
           tw.GraphDelta(idx=(np.array([0]), np.array([0])),
                         values=np.array([3], np.int32))]
    assert tw.apply_delta("assignment", w, seq)[0, 0] == 3
    adj = np.zeros((3, 4), bool)
    a2 = tw.apply_delta("matching", adj, tw.GraphDelta(
        idx=(np.array([2]), np.array([1])), values=True))
    assert a2[2, 1] and not adj.any()
    with pytest.raises(ValueError, match="field"):
        tw.apply_delta("maxflow", p, tw.GraphDelta(
            idx=(np.array([0]),), values=np.array([1.0]), field="nope"))
    with pytest.raises(TypeError, match="GraphDelta"):
        tw.apply_delta("assignment", w, [("not", "a delta")])
    with pytest.raises(ValueError, match="negative"):
        tw.apply_delta("maxflow", p, tw.GraphDelta(
            idx=(np.array([0]), np.array([0])), values=-1.0,
            field="cap_src"))


def test_delta_bound_and_content_key():
    rng = np.random.default_rng(8)
    w = rng.integers(0, 9, (4, 4)).astype(np.int32)
    w2 = w.copy()
    w2[2, 2] += 5
    assert tw.delta_bound(w2, w) == 5.0 == jw.delta_bound(w2, w)
    assert tw.delta_bound(w, w) == 0.0
    k1, k2 = tw.content_key("assignment", w), tw.content_key("assignment", w2)
    assert k1 != k2 and k1 == tw.content_key("assignment", w.copy())
    # kind participates in the key
    adj = np.zeros((4, 4), bool)
    assert tw.content_key("matching", adj) != tw.content_key(
        "matching", np.zeros((4, 5), bool))
    # the reference's digest, for numpy and for tensor leaves
    p = _grid(rng)
    tensors = {"assignment": torch.as_tensor(w),
               "matching": torch.as_tensor(adj),
               "maxflow": GridProblem(*map(torch.as_tensor, p))}
    for kind, payload in (("assignment", w), ("matching", adj),
                          ("maxflow", p)):
        want = jw.content_key(kind, _jax(kind, payload))
        assert tw.content_key(kind, payload) == want
        assert tw.content_key(kind, tensors[kind]) == want
    p2 = _mutate_grid(rng, p)
    assert tw.delta_bound(p2, p) == jw.delta_bound(_jax("maxflow", p2),
                                                   _jax("maxflow", p))
    # adjacencies: bool against bool, and against a 0/1 int copy
    a = random_bipartite(rng, 9, 8, 0.3)
    for b in (a, _mutate_adj(rng, a), _mutate_adj(rng, a).astype(np.int64)):
        assert tw.delta_bound(b, a) == jw.delta_bound(b, a)
        assert tw.delta_bound(torch.as_tensor(b), a) == jw.delta_bound(b, a)
    with pytest.raises(ValueError, match="shape"):
        tw.delta_bound(w[:3], w)
    with pytest.raises(ValueError, match="structure"):
        tw.delta_bound(p, w)


def test_tree_order_matches_jax():
    """The port's flattener walks dicts in sorted key order, drops
    ``None`` and walks named tuples field by field, as ``jax.tree.leaves``
    does: on the three kinds' payloads and solutions and on a dict whose
    keys were inserted out of order."""
    rng = np.random.default_rng(10)
    trees = [_grid(rng), rng.integers(0, 9, (3, 3)),
             random_bipartite(rng, 3, 4, 0.5)]
    for kind, payload in zip(KINDS, trees):
        res = solve_batch(kind, [payload], device=CPU)[0]
        trees += [get_kind(kind).solution_of(res), res]
    trees.append({"z": np.arange(2), "a": np.arange(3.0),
                  "m": {"y": np.int32(4), "b": None}, "c": [np.ones(1)]})
    for t in trees:
        leaves, treedef = tree_flatten(t)
        jl = jax.tree.leaves(t)
        assert len(leaves) == len(jl)
        for a, b in zip(leaves, jl):
            assert_same(np.asarray(to_numpy(a)), np.asarray(b))
        again = tree_leaves(tree_unflatten(treedef, leaves))
        assert all(a is b for a, b in zip(again, leaves))
        assert len(again) == len(leaves)


def test_solution_cache_lru_and_budgets():
    rng = np.random.default_rng(9)
    cache = tw.SolutionCache(max_entries=2)
    ws = [rng.integers(0, 9, (4, 4)).astype(np.int32) for _ in range(3)]
    keys = [cache.put("assignment", w, {"p_y": torch.zeros(4,
                                                           dtype=torch.int32)})
            for w in ws]
    assert keys == [jw.content_key("assignment", w) for w in ws]
    assert len(cache) == 2
    assert cache.get(keys[0]) is None          # LRU'd out (no spill dir)
    assert cache.get(keys[2]) is not None
    assert cache.get(keys[1]) is not None
    st_ = cache.stats()
    assert st_["hits"] == 2 and st_["misses"] == 1
    assert st_["hit_rate"] == 2 / 3 and st_["entries"] == 2
    # a hit refreshes: keys[1] was read last, so keys[2] goes next
    cache.put("assignment", ws[0], {"p_y": np.zeros(4, np.int32)})
    assert cache.get(keys[2]) is None and cache.get(keys[1]) is not None
    assert cache.nbytes == 2 * (4 * 4 * 4 + 4 * 4)
    # byte budget: the sole entry is never evicted
    tiny = tw.SolutionCache(max_entries=8, max_bytes=1)
    k = tiny.put("assignment", ws[0], {"p_y": np.zeros(4, np.int32)})
    assert tiny.get(k) is not None
    tiny.put("assignment", ws[1], {"p_y": np.zeros(4, np.int32)})
    assert len(tiny) == 1 and tiny.get(k) is None
    with pytest.raises(ValueError, match="max_entries"):
        tw.SolutionCache(max_entries=0)


def test_solution_cache_spills_and_reloads(tmp_path):
    rng = np.random.default_rng(10)
    cache = tw.SolutionCache(max_entries=1, spill_dir=str(tmp_path))
    w0 = rng.integers(0, 9, (4, 4)).astype(np.int32)
    w1 = rng.integers(0, 9, (4, 4)).astype(np.int32)
    k0 = cache.put("assignment", w0,
                   {"p_y": torch.arange(4, dtype=torch.int32)})
    cache.put("assignment", w1, {"p_y": np.zeros(4, np.int32)})
    assert cache.stats()["spilled"] == 1       # k0 spilled to disk
    assert any(d.startswith("kv_") for d in os.listdir(tmp_path))
    hit = cache.get(k0)                        # transparently reloaded
    assert hit is not None
    assert_same(hit.solution, {"p_y": np.arange(4, dtype=np.int32)})
    assert_same(hit.problem, w0)
    assert cache.stats()["spilled"] == 1       # w1 spilled in its turn
    # and the reloaded solution still warm-starts correctly
    w2 = _mutate_w(rng, w0)
    res = _solve_warm_both("assignment", [w2], {0: tw.WarmStart(
        hit.solution, base_problem=hit.problem)})
    assert int(res[0].weight) == optimal_weight(w2)
    # a grid entry's structure survives the spill (named tuple, dict)
    p = _grid(rng)
    sol = get_kind("maxflow").solution_of(
        solve_batch("maxflow", [p], device=CPU)[0])
    kp = cache.put("maxflow", p, sol)
    cache.put("assignment", w0, {"p_y": np.zeros(4, np.int32)})
    back = cache.get(kp)
    assert isinstance(back.problem, GridProblem)
    assert_same(back.problem, p)
    assert_same(back.solution, sol)


def test_solve_warm_errors():
    w = np.random.default_rng(11).integers(0, 9, (4, 4))
    sol = {"p_y": np.zeros(4, np.int32)}
    with pytest.raises(ValueError, match="out of range"):
        tw.solve_warm("assignment", [w], {3: tw.WarmStart(sol)}, device=CPU)
    with pytest.raises(TypeError, match="WarmStart"):
        tw.solve_warm("assignment", [w], {0: sol}, device=CPU)
    with pytest.raises(ValueError, match="unknown solver kind"):
        tw.solve_warm("nope", [w], {}, device=CPU)
    assert tw.solve_warm("assignment", [], {}, device=CPU) == []
