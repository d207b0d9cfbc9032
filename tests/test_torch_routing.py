"""The port's MoE routers (``repro_torch.core.routing``) against the JAX
package's, on the CPU.

Both get the same seeded numpy scores. Dispatch and demand must be equal
and the prices equal bit for bit: the routers decide with subtractions,
top-k values, comparisons, stable sorts, bool sums, argmax and adds, all
exact in IEEE float32. The combine weights are softmaxes (``exp`` differs
by an ulp or so between the libraries): within ``COMBINE_TOL`` (1e-6,
absolute; they lie in [0, 1]). Score sets include skewed ones (a
per-expert offset of std 0.5, and one hot expert) on which the auction's
price rounds engage, and sets full of exact ties.

The reference's ``tests/test_routing.py`` properties run here as
fixed-seed cases.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from repro.core import routing as jr
from repro_torch.core import routing as tr

COMBINE_TOL = 1e-6


def _scores(seed, shape, skew: float = 0.0, ties: bool = False):
    rng = np.random.default_rng(seed)
    if ties:       # few distinct values, signed zeros among them
        s = rng.integers(-2, 3, shape).astype(np.float32) * 0.5
        s[..., ::3, 1] = -0.0
        return s
    s = rng.normal(size=shape).astype(np.float32)
    if skew:
        s += (rng.normal(size=shape[:-2] + (1, shape[-1])) * skew).astype(
            np.float32)
    return s


def _same(got: tr.Routing, want: jr.Routing):
    want = [np.asarray(x) for x in want]
    got = [x.numpy() for x in got]
    for name, g, w in zip(tr.Routing._fields, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.dtype,
                                                           w.dtype)
    d, c, p, n = got
    wd, wc, wp, wn = want
    assert np.array_equal(d, wd), int((d != wd).sum())
    assert np.array_equal(n, wn)
    assert np.array_equal(p.view(np.int32), wp.view(np.int32)), \
        np.abs(p - wp).max()
    np.testing.assert_allclose(c, wc, rtol=0, atol=COMBINE_TOL)


def _capacity(T, E, k, which):
    """Capacity at factor 1.0 or 1.25 (below T), or T itself."""
    if which == "T":
        return T
    return max(1, int(T * k / E * float(which)))


SHAPES = [(64, 8), (3, 48, 8), (2, 2, 40, 4), (256, 16)]
SCORE_SETS = ["normal", "skewed", "hot", "ties"]


def _score_set(kind, shape, seed):
    if kind == "hot":
        s = _scores(seed, shape)
        s[..., 0] += 3.0                    # everyone loves expert 0
        return s
    return _scores(seed, shape, skew=0.5 * (kind == "skewed"),
                   ties=kind == "ties")


@pytest.mark.parametrize("which", ["1.0", "1.25", "T"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("kind", SCORE_SETS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_topk_route_equals_jax(shape, kind, k, which):
    s = _score_set(kind, shape, seed=len(shape) + k)
    T, E = shape[-2:]
    cap = _capacity(T, E, k, which)
    _same(tr.topk_route(torch.tensor(s), k, cap),
          jr.topk_route(jnp.asarray(s), k, cap))


@pytest.mark.parametrize("which", ["1.0", "1.25", "T"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("kind", SCORE_SETS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_auction_route_equals_jax(shape, kind, k, which):
    s = _score_set(kind, shape, seed=len(shape) + k)
    T, E = shape[-2:]
    cap = _capacity(T, E, k, which)
    got = tr.auction_route(torch.tensor(s), k, cap)
    want = jr.auction_route(jnp.asarray(s), k, cap)
    _same(got, want)
    if which == "T":
        assert not got.prices.any()
    elif kind in ("skewed", "hot"):
        assert got.prices.max() > 0          # the price rounds engaged


@pytest.mark.parametrize("n_iters,eps", [(1, 1e-2), (16, 1e-2), (8, 0.3)])
def test_auction_route_rounds_and_eps_equal_jax(n_iters, eps):
    s = _scores(7, (4, 128, 16), skew=0.5)
    got = tr.auction_route(torch.tensor(s), 2, 20, n_iters=n_iters, eps=eps)
    _same(got, jr.auction_route(jnp.asarray(s), 2, 20, n_iters=n_iters,
                                eps=eps))
    assert got.prices.max() > 0


def test_keep_topc_per_expert_equals_jax_on_ties():
    """Columns full of NEG ties and equal bids: the stable ranks decide."""
    s = _scores(3, (2, 30, 4), ties=True)
    picked = np.random.default_rng(3).random(s.shape) < 0.5
    for cap in (1, 4, 30):
        got = tr._keep_topc_per_expert(torch.tensor(s),
                                       torch.tensor(picked), cap)
        want = jr._keep_topc_per_expert(jnp.asarray(s), jnp.asarray(picked),
                                        cap)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_auction_route_on_bfloat16_scores_equals_jax():
    """bfloat16 scores: auction computes in float32 and returns combine in
    the scores' dtype, as the reference."""
    s = _scores(1, (32, 8), skew=0.5)
    got = tr.auction_route(torch.tensor(s).bfloat16(), 2, 6)
    want = jr.auction_route(jnp.asarray(s).astype(jnp.bfloat16), 2, 6)
    assert got.combine.dtype == torch.bfloat16
    assert np.array_equal(got.dispatch.numpy(), np.asarray(want.dispatch))
    assert np.array_equal(got.prices.numpy(), np.asarray(want.prices))


# ---------------------------------------------------------------------------
# Exact routers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,cap", [((64, 8), 8), ((2, 32, 4), 8),
                                       ((48, 16), 3)], ids=str)
def test_exact_route_equals_jax_and_scipy(shape, cap):
    s = _scores(0, shape)
    got = tr.exact_route(torch.tensor(s), cap)
    want = jr.exact_route(jnp.asarray(s), cap)
    assert np.array_equal(got.dispatch.numpy(), np.asarray(want.dispatch))
    assert np.array_equal(got.demand.numpy(), np.asarray(want.demand))
    assert np.array_equal(got.prices.numpy(), np.asarray(want.prices))
    np.testing.assert_allclose(got.combine.numpy(), np.asarray(want.combine),
                               rtol=0, atol=COMBINE_TOL)
    for b, sb in enumerate(s.reshape((-1,) + shape[-2:])):
        w = np.round(np.repeat(sb, cap, axis=1) * 1000)
        r_, c_ = linear_sum_assignment(w, maximize=True)
        d = got.dispatch.numpy().reshape((-1,) + shape[-2:])[b]
        assert (d * np.round(sb * 1000)).sum() == w[r_, c_].sum()
    assert got.demand.numpy().max() <= cap


@pytest.mark.parametrize("seed,n_x,n_y,k,cap", [(0, 12, 4, 2, 8),
                                                (1, 10, 3, 1, 5),
                                                (2, 9, 5, 3, 6)])
def test_solve_transportation_equals_jax_and_scipy(seed, n_x, n_y, k, cap):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 50, (n_x, n_y))
    supply, capacity = np.full(n_x, k), np.full(n_y, cap)
    flow, res = tr.solve_transportation(w, supply, capacity, device="cpu")
    jflow, jres = jr.solve_transportation(jnp.asarray(w), supply, capacity)
    assert flow.dtype == torch.int32
    assert np.array_equal(flow.numpy(), np.asarray(jflow))
    assert np.array_equal(res.col_of_row.numpy(), np.asarray(jres.col_of_row))
    assert int(res.rounds) == int(jres.rounds)
    rows = np.repeat(np.arange(n_x), supply)
    cols = np.repeat(np.arange(n_y), capacity)
    big = np.zeros((capacity.sum(), capacity.sum()))
    big[:len(rows), :] = w[rows][:, cols]
    r_, c_ = linear_sum_assignment(big, maximize=True)
    f = flow.numpy()
    assert (f.sum(1) == supply).all() and (f.sum(0) <= capacity).all()
    assert (f * w).sum() == int(big[r_, c_].sum())


def test_solve_transportation_refuses_infeasible():
    with pytest.raises(ValueError, match="infeasible"):
        tr.solve_transportation(np.ones((4, 2)), np.full(4, 2),
                                np.full(2, 3), device="cpu")


def test_routing_runs_on_the_scores_device_and_card_default():
    s = torch.tensor(_scores(0, (16, 4)))
    for r in (tr.topk_route(s, 2, 8), tr.auction_route(s, 2, 8),
              tr.exact_route(s, 4)):
        assert all(x.device == s.device for x in r)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tr.solve_transportation(np.ones((2, 2)), [1, 1], [1, 1])


# ---------------------------------------------------------------------------
# The reference's properties (tests/test_routing.py), fixed seeds
# ---------------------------------------------------------------------------

def test_exact_route_is_optimal():
    T, E = 64, 8
    cap = T // E
    s = _scores(0, (T, E))
    w = np.repeat(s, cap, axis=1)
    r_, c_ = linear_sum_assignment(w, maximize=True)
    r = tr.exact_route(torch.tensor(s), cap)
    assert abs(float((s * r.dispatch.numpy()).sum()) - w[r_, c_].sum()) < 1e-3
    assert int(r.dispatch.sum()) == T                      # zero drops


def test_auction_route_beats_topk_on_drops():
    T, E, k = 128, 8, 1
    s = torch.tensor(_scores(1, (T, E)))
    dropped_topk = T - int(tr.topk_route(s, k, T // E).dispatch.sum())
    dropped_auct = T - int(tr.auction_route(s, k, T // E,
                                            n_iters=16).dispatch.sum())
    assert dropped_auct <= dropped_topk
    assert dropped_auct == 0


# (seed, E, k, T): draws of the reference's Hypothesis property
FEASIBILITY_CASES = [(0, 2, 1, 8), (1, 8, 3, 64), (2, 5, 2, 17),
                     (3, 3, 3, 9), (4, 8, 1, 31), (5, 4, 2, 64),
                     (6, 7, 3, 40), (7, 2, 2, 11), (8, 6, 1, 50),
                     (9999, 8, 2, 63)]


@pytest.mark.parametrize("seed,E,k,T", FEASIBILITY_CASES)
def test_routing_feasibility(seed, E, k, T):
    """Never more than k experts per token nor capacity tokens per
    expert; combine 0 off the dispatch and finite; equal to JAX."""
    k = min(k, E)
    cap = max(1, int(T * k / E * 1.25))
    s = _scores(seed, (T, E))
    for name in ("topk_route", "auction_route"):
        r = getattr(tr, name)(torch.tensor(s), k, cap)
        _same(r, getattr(jr, name)(jnp.asarray(s), k, cap))
        d, c = r.dispatch.numpy(), r.combine.numpy()
        assert d.sum(axis=0).max() <= cap
        assert d.sum(axis=1).max() <= k
        assert (c[~d] == 0).all()
        assert np.isfinite(c).all()


def test_flow_router_better_balance():
    """Skewed logits: flow routing caps hot experts, topk truncates."""
    rng = np.random.default_rng(5)
    T, E, k = 256, 8, 2
    s = rng.normal(size=(T, E)).astype(np.float32)
    s[:, 0] += 3.0
    cap = int(T * k / E * 1.25)
    rt = tr.topk_route(torch.tensor(s), k, cap)
    ra = tr.auction_route(torch.tensor(s), k, cap, n_iters=16)
    assert int(ra.dispatch.sum()) >= int(rt.dispatch.sum())
    _same(ra, jr.auction_route(jnp.asarray(s), k, cap, n_iters=16))


def test_transportation_exact():
    rng = np.random.default_rng(0)
    n_x, n_y = 12, 4
    w = rng.integers(0, 50, (n_x, n_y))
    supply, capacity = np.full(n_x, 2), np.full(n_y, 8)
    flow, _ = tr.solve_transportation(torch.tensor(w), supply, capacity)
    f = flow.numpy()
    assert (f.sum(1) == supply).all()
    assert (f.sum(0) <= capacity).all()
    rows = np.repeat(np.arange(n_x), supply)
    cols = np.repeat(np.arange(n_y), capacity)
    big = np.zeros((capacity.sum(), capacity.sum()))
    big[:len(rows), :] = w[rows][:, cols]
    r_, c_ = linear_sum_assignment(big, maximize=True)
    assert (f * w).sum() == int(big[r_, c_].sum())
