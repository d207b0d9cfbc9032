"""The solver-kind registry and the public surface of ``repro_torch.core``,
against the JAX package.

Checked: ``registered_kinds()`` is ``("maxflow", "assignment",
"matching")`` in both packages; ``SolverKind._fields`` equal the
reference's; ``repro_torch.core.__all__ == repro.core.__all__``; unknown
kinds raise naming the registered ones from ``get_kind`` and from every
front end; duplicate and malformed names raise; ``ensure=False`` peeks;
each builtin kind's ``loop_spec`` factory hands back the solver's cached
spec, its warm-start hooks (``init_state``, ``warm_state``,
``solution_of``; ROADMAP M6) give the reference's states and solutions,
and its ``validate`` accepts and refuses what the reference's does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import assert_same

import repro.core as jcore
import repro.core.batch as jbatch
import repro.core.kinds as jkinds
import repro_torch.core as tcore
import repro_torch.core.kinds as kinds_mod
from repro_torch.core.batch import prepare_buckets, solve_batch
from repro_torch.core.kinds import (SolverKind, get_kind, register_kind,
                                    registered_kinds)
from repro_torch.core.refill import RefillSolver, refill_runtime

BUILTIN = ("maxflow", "assignment", "matching")


def _dummy_kind(name):
    f = lambda *a, **k: None  # noqa: E731
    return SolverKind(name=name, validate=f, inert_problem=f,
                      prepare_buckets=f, solve_prepared=f, loop_spec=f)


def test_public_surface_equals_the_reference():
    assert tcore.__all__ == jcore.__all__
    for name in tcore.__all__:
        assert hasattr(tcore, name), name


def test_solver_kind_fields_equal_the_reference():
    assert SolverKind._fields == jkinds.SolverKind._fields
    assert SolverKind._field_defaults == jkinds.SolverKind._field_defaults


def test_registered_kinds_order_and_peek():
    assert registered_kinds() == BUILTIN == jkinds.registered_kinds()[:3]
    assert set(registered_kinds(ensure=False)) == set(registered_kinds())
    assert get_kind("maxflow").name == "maxflow"


def test_unknown_kind_names_registered_kinds():
    with pytest.raises(ValueError) as ei:
        get_kind("tsp")
    msg = str(ei.value)
    assert "unknown solver kind 'tsp'" in msg
    for name in BUILTIN:
        assert name in msg


def test_unknown_kind_raises_from_every_front_end():
    with pytest.raises(ValueError, match="registered kinds"):
        solve_batch("tsp", [object()], device="cpu")
    with pytest.raises(ValueError, match="registered kinds"):
        prepare_buckets("tsp", [object()])
    with pytest.raises(ValueError, match="registered kinds"):
        RefillSolver("tsp", shape=(4,), capacity=1, device="cpu")
    with pytest.raises(ValueError, match="registered kinds"):
        refill_runtime("tsp", device="cpu")


def test_duplicate_registration_raises(monkeypatch):
    registered_kinds()
    with pytest.raises(ValueError, match="already registered"):
        register_kind(_dummy_kind("matching"))
    monkeypatch.delitem(kinds_mod._REGISTRY, "scratch", raising=False)
    register_kind(_dummy_kind("scratch"))
    try:
        with pytest.raises(ValueError, match="already registered"):
            register_kind(_dummy_kind("scratch"))
        assert "scratch" in registered_kinds()
    finally:
        del kinds_mod._REGISTRY["scratch"]


def test_malformed_kind_name_raises():
    with pytest.raises(ValueError, match="non-empty string"):
        register_kind(_dummy_kind(""))
    with pytest.raises(ValueError, match="non-empty string"):
        register_kind(_dummy_kind(None))


def test_builtin_kinds_register_every_capability_but_warm_start():
    # The name predates M6: the warm-start hooks are registered now, and
    # held here to the reference's in effect.
    payloads = _hook_payloads()
    for name in BUILTIN:
        k = get_kind(name)
        ref = jkinds.get_kind(name)
        for field in ("validate", "inert_problem", "prepare_buckets",
                      "solve_prepared", "loop_spec", "refill", "init_state",
                      "warm_state", "solution_of"):
            assert callable(getattr(k, field)), (name, field)
        p = payloads[name]
        jp = (jbatch.GridProblem(*map(jnp.asarray, p)) if name == "maxflow"
              else p)
        res = solve_batch(name, [p], device="cpu")[0]
        jres = jbatch.solve_batch(name, [jp])[0]
        sol, jsol = k.solution_of(res), ref.solution_of(jres)
        assert_same(sol, jsol)
        rt, jrt = k.refill(device="cpu"), ref.refill()
        shape = rt.shape_of(k.validate(p))
        p1, jp1 = rt.pad_one(k.validate(p), shape), jrt.pad_one(
            ref.validate(jp), shape)
        assert_same(k.init_state(device="cpu")(p1), ref.init_state()(jp1))
        assert_same(k.warm_state(device="cpu")(p1, sol, base_problem1=p1,
                                               delta_bound=1.0),
                    ref.warm_state()(jp1, {key: np.asarray(v) for key, v
                                           in jsol.items()},
                                     base_problem1=jp1, delta_bound=1.0))
        spec = k.loop_spec()
        assert spec is k.loop_spec()         # cached per knob tuple
        assert spec.rounds_per_cycle == ref.loop_spec().rounds_per_cycle
        assert (spec.heur is None) == (ref.loop_spec().heur is None)
        assert refill_runtime(name, device="cpu").spec is spec


def _hook_payloads():
    """One payload per builtin kind for the warm-start hooks."""
    rng = np.random.default_rng(1)
    from repro_torch.core.matching.ref import random_bipartite
    from repro_torch.core.maxflow.grid import GridProblem
    from repro_torch.core.maxflow.ref import random_grid_problem
    return {"maxflow": GridProblem(*random_grid_problem(rng, 5, 6)),
            "assignment": rng.integers(0, 30, (5, 5)),
            "matching": random_bipartite(rng, 6, 5, 0.4)}


def _payloads():
    rng = np.random.default_rng(0)
    from repro_torch.core.maxflow.ref import random_grid_problem
    return {
        "maxflow": ([random_grid_problem(rng, 4, 5)],
                    [(np.ones((4, 3, 3)), np.ones((3, 3)), np.ones((3, 4))),
                     (np.ones((4, 3, 3), bool), np.ones((3, 3)),
                      np.ones((3, 3))),
                     (-np.ones((4, 3, 3)), np.ones((3, 3)), np.ones((3, 3))),
                     (np.full((4, 3, 3), np.nan), np.ones((3, 3)),
                      np.ones((3, 3)))]),
        "assignment": ([rng.integers(0, 9, (4, 4))],
                       [np.ones((3, 4), int), np.ones((3, 3)),
                        np.ones((2, 2, 2), int)]),
        "matching": ([rng.random((3, 5)) < 0.5,
                      (np.array([[0, 1], [2, 0]]), (3, 2)),
                      np.eye(3, dtype=int)],
                     [np.zeros((0, 3)), np.full((2, 2), 2),
                      (np.array([[0, 5]]), (2, 2)),
                      (np.array([[-1, 0]]), (2, 2)),
                      np.zeros((2, 2, 2))]),
    }


@pytest.mark.parametrize("name", BUILTIN)
def test_validators_agree_with_the_reference(name):
    good, bad = _payloads()[name]
    k, ref = get_kind(name), jkinds.get_kind(name)
    for p in good:
        got, want = k.validate(p), ref.validate(p)
        for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (got, want))):
            assert np.array_equal(np.asarray(g), np.asarray(w))
    for p in bad:
        with pytest.raises(ValueError, match="malformed") as ei:
            k.validate(p)
        with pytest.raises(ValueError, match="malformed") as ej:
            ref.validate(p)
        assert str(ei.value).split(":")[0] == str(ej.value).split(":")[0]
