"""Cost-scaling assignment through ``solve_assignment``: the port against
the JAX package.

For both methods (``auction``, ``pushrelabel``) and both backends
(``xla``, ``pallas``; the JAX package runs its Pallas kernel in interpret
mode, the port K4's plain version on the CPU), the same seeded integer
weights go through both solvers. Checked: every result leaf and counter,
dtypes included; the weight against scipy's optimum; single ``(n, n)``
and batched ``(B, n, n)`` weights, with the port's batch equal to a loop
of its single solves; the reference tests' heuristic ablations; a solve
cut short by ``max_rounds``; and one round, one price update and one
cycle fed the same mid-solve JAX state through ``repro_torch.interop``.
The ε-optimality check is compared as a verdict (the port's against the
JAX package's), since the push-relabel refine can end with prices that
are not 1-optimal in both packages alike. Tolerance: exact equality
(integers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same

from repro.core.assignment import cost_scaling as jc
from repro.core.assignment import ref as jref
from repro_torch.core.assignment import cost_scaling as tc
from repro_torch.core.assignment.ref import (eps_optimal, optimal_weight,
                                             optimal_weight_bruteforce)
from repro_torch.interop import to_numpy, to_torch
from repro_torch.launch.mesh import make_solver_mesh

METHODS = ["auction", "pushrelabel"]
BACKENDS = ["xla", "pallas"]


def _weights(batch: tuple, n: int, seed: int = 0, lo: int = 0,
             hi: int = 101):
    return np.random.default_rng(seed).integers(lo, hi, size=batch + (n, n))


def _both(w, **kw):
    want = jc.solve_assignment(jnp.asarray(w, jnp.int32), **kw)
    got = tc.solve_assignment(w, device="cpu", **kw)
    assert_same(got, want)
    return got, want


def _eps_verdicts(w, got, want):
    """Per instance: (port eps_optimal on the port's result, JAX eps_optimal
    on the JAX result) at ε = 1."""
    out = []
    for b in np.ndindex(w.shape[:-2]):
        n = w.shape[-1]
        verdicts = []
        for res, check in ((to_numpy(got), eps_optimal),
                           (to_numpy(want), jref.eps_optimal)):
            F = np.zeros((n, n), np.int32)
            F[np.arange(n), res["col_of_row"][b]] = 1
            verdicts.append(check(w[b], F, res["p_x"][b], res["p_y"][b],
                                  eps=1))
        out.append(tuple(verdicts))
    return out


def test_ref_copies_match_jax():
    rng = np.random.default_rng(4)
    for n in (1, 4, 5):
        w = rng.integers(-20, 101, size=(n, n))
        assert optimal_weight(w) == jref.optimal_weight(w)
        assert (optimal_weight_bruteforce(w)
                == jref.optimal_weight_bruteforce(w))
        assert optimal_weight(w) == optimal_weight_bruteforce(w)
    w = rng.integers(0, 101, size=(12, 12))
    for _ in range(20):
        F = (rng.random((12, 12)) < 0.1).astype(np.int32)
        p_x = rng.integers(-3000, 3000, 12).astype(np.int32)
        p_y = rng.integers(-3000, 3000, 12).astype(np.int32)
        for eps in (1, 500, 5000):
            assert (eps_optimal(w, F, p_x, p_y, eps)
                    == jref.eps_optimal(w, F, p_x, p_y, eps))


@pytest.mark.parametrize("batch", [(), (3,)], ids=["single", "batched"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method", METHODS)
def test_solve_assignment_matches_jax(method, backend, batch):
    w = _weights(batch, 20 if not batch else 16, seed=len(batch))
    got, want = _both(w, method=method, backend=backend)
    assert bool(got.converged.all())
    assert got.weight.reshape(-1).tolist() == [
        optimal_weight(w[b]) for b in np.ndindex(batch)]
    for port_ok, jax_ok in _eps_verdicts(w, got, want):
        assert port_ok == jax_ok
    assert got.rounds.dtype == got.weight.dtype == torch.int32


@pytest.mark.parametrize("method", METHODS)
def test_batch_equals_loop_of_singles(method):
    w = _weights((3,), 16, seed=7)
    batched = to_numpy(tc.solve_assignment(w, method=method,
                                           backend="pallas", device="cpu"))
    for b in range(3):
        single = to_numpy(tc.solve_assignment(w[b], method=method,
                                              backend="pallas", device="cpu"))
        for key, v in batched.items():
            assert np.array_equal(v[b], single[key]), key


@pytest.mark.parametrize("kw", [
    dict(use_price_update=False, use_arc_fixing=False),
    dict(use_price_update=True, use_arc_fixing=False),
    dict(use_price_update=False, use_arc_fixing=True),
    dict(method="pushrelabel", rounds_per_heuristic=4),
])
def test_heuristic_ablations_match_jax(kw):
    w = _weights((), 12, seed=1)
    got, _ = _both(w, **kw)
    assert int(got.weight) == optimal_weight(w)


def test_max_rounds_binding_matches_jax():
    """Refines cut after one round: unmatched rows carry the sentinel n."""
    w = _weights((2,), 16, seed=5)
    got, _ = _both(w, max_rounds=1, rounds_per_heuristic=1)
    assert not bool(got.converged.any())
    assert bool((got.col_of_row == 16).any())


def test_negative_tiny_and_paper_size_match_jax():
    w = _weights((), 6, seed=9, lo=-50, hi=51)
    got, _ = _both(w, method="auction")
    assert int(got.weight) == optimal_weight(w) == optimal_weight_bruteforce(w)
    got, _ = _both(np.asarray([[7]]), method="auction")
    assert int(got.weight) == 7
    w = np.random.default_rng(2011).integers(0, 101, size=(30, 30))
    got, _ = _both(w, method="pushrelabel", backend="pallas")
    assert int(got.weight) == optimal_weight(w)


def _jax_scale_state(batch: tuple, method: str, rounds: int):
    """A JAX mid-solve ``_ScaleState``: init, then ``rounds`` rounds."""
    w = _weights(batch, 12, seed=3)
    s = jc._scale_init(jnp.asarray(w, jnp.int32), alpha=10)
    step = jax.jit({"auction": jc._round_auction,
                    "pushrelabel": jc._round_pushrelabel}[method])
    st = s.st
    for _ in range(rounds):
        st = step(s.c, s.eps, st)
    return s._replace(st=st)


@pytest.mark.parametrize("batch", [(), (2,)], ids=["single", "batched"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method", METHODS)
def test_one_round_matches_jax(method, backend, batch):
    s = _jax_scale_state(batch, method, rounds=5)
    fn = {"auction": "_round_auction", "pushrelabel": "_round_pushrelabel"}
    want = getattr(jc, fn[method])(s.c, s.eps, s.st, backend=backend)
    p = to_torch(s, "cpu")
    assert isinstance(p, tc._ScaleState) and isinstance(p.st, tc._RefineState)
    got = getattr(tc, fn[method])(p.c, p.eps, p.st, backend=backend)
    assert_same(got, want)


@pytest.mark.parametrize("max_sweeps", [1, 24])
@pytest.mark.parametrize("batch", [(), (2,)], ids=["single", "batched"])
def test_price_update_matches_jax(batch, max_sweeps):
    s = _jax_scale_state(batch, "pushrelabel", rounds=6)
    want = jc.price_update(s.c, s.eps, s.st, max_sweeps=max_sweeps)
    p = to_torch(s, "cpu")
    assert_same(tc.price_update(p.c, p.eps, p.st, max_sweeps=max_sweeps),
                want)


@pytest.mark.parametrize("method", METHODS)
def test_cycle_matches_jax(method):
    """Three cycles of the flattened ε-scaling spec, refine exits
    included, from the same initial state."""
    s = _jax_scale_state((3,), method, rounds=0)
    knobs = (method, 10, 200_000, 4, True, True, "xla")
    jspec = jc._assignment_spec(*knobs)
    tspec = tc._assignment_spec(*knobs)
    p = to_torch(s, "cpu")
    for _ in range(3):
        s, p = jspec.cycle(s), tspec.cycle(p)
        assert_same(p, s)


def test_errors():
    w = _weights((), 4)
    with pytest.raises(ValueError, match="unknown method 'hungarian'"):
        tc.solve_assignment(w, method="hungarian", device="cpu")
    with pytest.raises(ValueError, match="unknown backend 'triton'"):
        tc.solve_assignment(w, backend="triton", device="cpu")
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        tc.solve_assignment(w[:, :3], device="cpu")
    with pytest.raises(ValueError, match="batched"):   # compaction: M3
        tc.solve_assignment(w, compact=True, device="cpu")
    one_lane = make_solver_mesh(1, device="cpu")
    with pytest.raises(ValueError, match="batched"):    # lanes: (B, n, n)
        tc.solve_assignment(w, mesh=one_lane, device="cpu")
    with pytest.raises(ValueError, match="not in mesh axes"):
        tc.solve_assignment(w[None], mesh=one_lane, mesh_axis="model",
                            device="cpu")
    assert_same(tc.solve_assignment(w[None], mesh=one_lane, device="cpu"),
                tc.solve_assignment(w[None], device="cpu"))


def test_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tc.solve_assignment(_weights((), 4))
