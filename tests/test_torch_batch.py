"""The ragged pad-and-bucket front end: the port against the JAX package.

For every registered kind, a ragged queue (mixed shapes, ragged
convergence) goes through ``solve_batch`` under ``bucket="max"``,
``"pow2"`` and ``"exact"``, compacted and masked, in both packages:
every result leaf and every ``BucketStats`` (``spread`` included) must be
equal. Also checked: ``prepare_buckets`` + ``solve_prepared`` against
``solve_batch``; the host stage (bucket shapes, padding, inert instances
that are born converged, the bonus-shifted cost padding) against the
reference's; results against the oracles; the per-kind spellings; that
``warm=`` routes to ``solve_warm`` (ROADMAP M6) and one lane of
``mesh=`` (M7) equals no mesh.
Tolerance: exact equality (``assert_same``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same

import repro.core.batch as jb
from repro.core.matching import prepare_matching_buckets as jprep_matching
from repro_torch.core import batch as tb
from repro_torch.core.assignment.ref import optimal_weight
from repro_torch.core.kinds import get_kind
from repro_torch.core.matching import (hopcroft_karp,
                                       inert_matching_problem,
                                       prepare_matching_buckets)
from repro_torch.core.matching.ref import random_bipartite
from repro_torch.core.maxflow.grid import GridProblem
from repro_torch.core.maxflow.ref import maxflow_grid_ref, random_grid_problem
from repro_torch.core.warm import WarmStart, solve_warm
from repro_torch.launch.mesh import make_solver_mesh

CPU = "cpu"
KINDS = ["maxflow", "assignment", "matching"]
BUCKETS = ["max", "pow2", "exact"]


def queue(kind: str, seed: int = 0) -> list:
    """A ragged queue of ``kind`` payloads (numpy)."""
    rng = np.random.default_rng(seed)
    if kind == "maxflow":
        out = []
        for i, (h, w) in enumerate([(5, 5), (8, 8), (4, 7), (8, 8), (5, 5),
                                    (6, 3)]):
            cap, cs, ct = random_grid_problem(rng, h, w)
            if i % 2:
                cs = np.minimum(cs, 1.0)
            out.append(GridProblem(cap, cs, ct))
        return out
    if kind == "assignment":
        return [rng.integers(-30, 71, (n, n)) for n in (4, 9, 6, 9, 5, 3)]
    return [random_bipartite(rng, nl, nr, p) for nl, nr, p in
            [(5, 7, 0.3), (12, 12, 0.15), (3, 4, 0.5), (12, 9, 0.2),
             (7, 7, 0.0), (10, 12, 0.3), (12, 9, 0.5)]]


# fine-grained maxflow cycles and matching from the empty matching, so
# that instances of a bucket finish apart
KW = {"maxflow": dict(rounds_per_heuristic=4), "assignment": {},
      "matching": dict(greedy_init=False)}


def jax_payloads(kind: str, payloads: list) -> list:
    if kind == "maxflow":
        return [jb.GridProblem(*map(jnp.asarray, p)) for p in payloads]
    return payloads


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("bucket", BUCKETS)
@pytest.mark.parametrize("kind", KINDS)
def test_solve_batch_equals_jax(kind, bucket, compact):
    payloads = queue(kind)
    stats_j, stats_t = [], []
    want = jb.solve_batch(kind, jax_payloads(kind, payloads), bucket=bucket,
                          compact=compact, stats_out=stats_j, **KW[kind])
    got = tb.solve_batch(kind, payloads, bucket=bucket, compact=compact,
                         stats_out=stats_t, device=CPU, **KW[kind])
    assert len(got) == len(want) == len(payloads)
    for g, w in zip(got, want):
        assert_same(g, w)
    assert [tuple(s) for s in stats_t] == [tuple(s) for s in stats_j]
    assert [s.spread for s in stats_t] == [s.spread for s in stats_j]
    assert all(s.compact == compact for s in stats_t)
    assert any(s.spread > 0 for s in stats_t), "no ragged bucket"


@pytest.mark.parametrize("kind", KINDS)
def test_results_match_the_oracles(kind):
    payloads = queue(kind, seed=1)
    got = tb.solve_batch(kind, payloads, bucket="pow2", compact=True,
                         device=CPU)
    for p, r in zip(payloads, got):
        assert bool(r.converged)
        if kind == "maxflow":
            assert float(r.flow) == maxflow_grid_ref(*p)
            assert tuple(r.cut.shape) == p.cap_src.shape
        elif kind == "assignment":
            assert int(r.weight) == optimal_weight(p)
            assert sorted(r.col_of_row.tolist()) == list(range(len(p)))
        else:
            assert int(r.cardinality) == hopcroft_karp(p)[2]
            assert tuple(r.match_row.shape) == (p.shape[0],)


@pytest.mark.parametrize("kind", KINDS)
def test_prepare_then_solve_prepared_equals_jax(kind):
    payloads = queue(kind, seed=2)
    jprep = jb.prepare_buckets(kind, jax_payloads(kind, payloads),
                               bucket="pow2")
    tprep = tb.prepare_buckets(kind, payloads, bucket="pow2")
    assert [(p.kind, p.shape, p.idxs, p.shapes, p.n_pad) for p in tprep] \
        == [(p.kind, p.shape, p.idxs, p.shapes, p.n_pad) for p in jprep]
    for t, j in zip(tprep, jprep):
        assert_same(tuple(np.asarray(x, np.float64) for x in
                          (t.stacked if kind == "maxflow" else
                           (t.stacked,))),
                    tuple(np.asarray(x, np.float64) for x in
                          (j.stacked if kind == "maxflow" else
                           (j.stacked,))))
        got, gstats = tb.solve_prepared(t, compact=True, device=CPU)
        want, wstats = jb.solve_prepared(j, compact=True)
        assert sorted(got) == sorted(want) == list(t.idxs)
        for i in got:
            assert_same(got[i], want[i])
        assert gstats == wstats


def test_per_kind_spellings_equal_solve_batch():
    for kind, spell in (("maxflow", tb.solve_maxflow_batch),
                        ("assignment", tb.solve_assignment_batch)):
        payloads = queue(kind, seed=3)
        s1, s2 = [], []
        a = spell(payloads, bucket="exact", stats_out=s1, device=CPU)
        b = tb.solve_batch(kind, payloads, bucket="exact", stats_out=s2,
                           device=CPU)
        for x, y in zip(a, b):
            assert_same(x, y)
        assert s1 == s2


def test_inert_problems_are_born_converged_and_match_jax():
    assert_same(tb.inert_grid_problem(3, 5), jb.inert_grid_problem(3, 5))
    assert_same(tb.inert_cost_matrix(4), jb.inert_cost_matrix(4))
    for kind, shape in (("maxflow", (4, 6)), ("assignment", (5,)),
                        ("matching", (3, 7))):
        k = get_kind(kind)
        inert = k.inert_problem(shape)
        res = tb.solve_batch(kind, [inert, inert], device=CPU)
        assert all(int(r.rounds) == 0 or kind == "assignment" for r in res)
        assert all(bool(r.converged) for r in res)
        spec = k.loop_spec()
        rt = k.refill(device=CPU)
        state = rt.init(rt.pad_one(k.validate(inert), shape))
        live = spec.live(state, torch.zeros(1, dtype=torch.int32))
        assert not bool(live.any()) or kind == "assignment"
    assert np.array_equal(inert_matching_problem(2, 3),
                          np.zeros((2, 3), bool))


def test_pad_cost_matrix_equals_jax():
    rng = np.random.default_rng(4)
    for lo in (-30, 0, 5):
        w = rng.integers(lo, 50, (5, 5))
        got, bonus = tb.pad_cost_matrix(w, 8)
        want, jbonus = jb.pad_cost_matrix(w, 8)
        assert bonus == jbonus
        assert_same(got, want)
    p = GridProblem(*random_grid_problem(rng, 3, 4))
    assert_same(tuple(tb.pad_grid_problem(p, 5, 6)),
                tuple(np.asarray(x) for x in jb.pad_grid_problem(
                    jb.GridProblem(*map(jnp.asarray, p)), 5, 6)))
    adjs = queue("matching")
    for t, j in zip(prepare_matching_buckets(adjs, bucket="exact"),
                    jprep_matching(adjs, bucket="exact")):
        assert_same(t.stacked, j.stacked)


def test_empty_queue_and_errors():
    for kind in KINDS:
        assert tb.solve_batch(kind, [], device=CPU) == []
    with pytest.raises(ValueError, match="unknown bucket mode"):
        tb.solve_batch("assignment", queue("assignment"), bucket="odd",
                       device=CPU)
    # warm= routes to solve_warm, which refuses a non-WarmStart
    with pytest.raises(TypeError, match="WarmStart"):
        tb.solve_batch("assignment", queue("assignment"),
                       warm={0: object()}, device=CPU)
    ws = queue("assignment")
    sol = get_kind("assignment").solution_of(
        tb.solve_batch("assignment", ws[:1], device=CPU)[0])
    warm = {0: WarmStart(sol, base_problem=ws[0])}
    for a, b in zip(tb.solve_batch("assignment", ws, warm=warm, device=CPU),
                    solve_warm("assignment", ws, warm, device=CPU)):
        assert_same(a, b)
    # one lane is the solve without lanes; the axis must be the mesh's
    one_lane = make_solver_mesh(1, device=CPU)
    for a, b in zip(tb.solve_batch("assignment", ws, mesh=one_lane,
                                   device=CPU),
                    tb.solve_batch("assignment", ws, device=CPU)):
        assert_same(a, b)
    with pytest.raises(ValueError, match="not in mesh axes"):
        tb.solve_batch("assignment", ws, mesh=one_lane, mesh_axis="model",
                       device=CPU)
    # a mesh axis without a mesh pads nothing, as in the reference
    assert [p.n_pad for p in tb.prepare_buckets(
        "matching", queue("matching"), mesh_axis="batch")] == [0]
