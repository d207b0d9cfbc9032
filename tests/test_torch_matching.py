"""Bipartite matching through ``match_bipartite[_batch]``: the port against
the JAX package.

For both backends (``xla``, ``pallas``; the JAX package runs its Pallas
kernel in interpret mode, the port K5's plain version on the CPU), the
same instances from the port's generator copies (each checked against the
JAX package's generators) go through both solvers, with the greedy
initialization on and off. Checked: every result leaf, dtypes included;
the cardinality against Hopcroft–Karp; the port's batch against a loop of
its single solves; a solve cut short by ``max_rounds``; one phase and the
greedy init fed the same JAX state through ``repro_torch.interop``.
Tolerance: exact equality (integers and bools).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same

from repro.core.matching import bfs as jb
from repro.core.matching import ref as jref
from repro_torch.core.matching import (MatchingResult, hopcroft_karp,
                                       match_bipartite,
                                       match_bipartite_batch)
from repro_torch.core.matching import bfs as tb
from repro_torch.core.matching import ref as tref
from repro_torch.interop import to_numpy, to_torch
from repro_torch.launch.mesh import make_solver_mesh

BACKENDS = ["xla", "pallas"]
BLOCKS = [(4, 0), (0, 3), (5, 6), (3, 3)]
# each generator takes the ref module to draw from (the port's or JAX's)
GENERATORS = {
    "random": lambda m, rng: m.random_bipartite(rng, 24, 32, 0.12),
    "perfect": lambda m, rng: m.perfect_matching_instance(rng, 32, 0.08),
    "star": lambda m, rng: m.star_instance(24, 32, hub=3),
    "disconnected": lambda m, rng: m.disconnected_instance(rng, BLOCKS, 0.4),
}


def _instance(name: str, seed: int = 0) -> np.ndarray:
    return GENERATORS[name](tref, np.random.default_rng(seed))


def _chain(n: int) -> np.ndarray:
    """Hopcroft–Karp's worst case for depth: its first phase leaves one
    free row whose only augmenting path runs through all n rows."""
    adj = np.zeros((n, n), bool)
    for i in range(n):
        for j in (i, i + 1):
            if j < n:
                adj[i, n - 1 - j] = True
    return adj


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_and_oracle_match_jax(name):
    for seed in range(3):
        adj = _instance(name, seed)
        assert_same(adj, GENERATORS[name](jref, np.random.default_rng(seed)))
        assert hopcroft_karp(adj)[2] == jref.hopcroft_karp(adj)[2]


def test_oracle_on_deep_augmenting_path():
    """The port's iterative DFS: a path through every row, deeper than
    Python's recursion limit at n = 3000, and the recursive reference
    where it still fits."""
    assert hopcroft_karp(_chain(200))[2] == jref.hopcroft_karp(_chain(200))[2]
    mr, mc, card = hopcroft_karp(_chain(3000))
    assert card == 3000
    assert all(mc[j] == i for i, j in enumerate(mr))


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "nogreedy"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_match_bipartite_matches_jax(name, backend, greedy):
    adj = _instance(name, 1)
    want = jb.match_bipartite(jnp.asarray(adj), backend=backend,
                              greedy_init=greedy)
    got = match_bipartite(adj, backend=backend, greedy_init=greedy,
                          device="cpu")
    assert isinstance(got, MatchingResult)
    assert_same(got, want)
    assert bool(got.converged)
    assert int(got.cardinality) == hopcroft_karp(adj)[2]
    assert got.cardinality.dtype == got.rounds.dtype == torch.int32


@pytest.mark.parametrize("backend", BACKENDS)
def test_match_bipartite_batch_matches_jax_and_singles(backend):
    adj = np.stack([_instance("random", s) for s in range(2)]
                   + [_instance("star"), np.zeros((24, 32), bool)])
    want = jb.match_bipartite_batch(jnp.asarray(adj), backend=backend)
    got = match_bipartite_batch(adj, backend=backend, device="cpu")
    assert_same(got, want)
    assert got.cardinality.tolist() == [hopcroft_karp(a)[2] for a in adj]
    batched = to_numpy(got)
    for b in range(adj.shape[0]):
        single = to_numpy(match_bipartite(adj[b], backend=backend,
                                          device="cpu"))
        for key, v in batched.items():
            assert np.array_equal(v[b], single[key]), key


def test_max_rounds_binding_matches_jax():
    adj = np.stack([_instance("perfect", s) for s in range(3)])
    for backend in BACKENDS:
        want = jb.match_bipartite_batch(jnp.asarray(adj), backend=backend,
                                        max_rounds=1, greedy_init=False)
        got = match_bipartite_batch(adj, backend=backend, max_rounds=1,
                                    greedy_init=False, device="cpu")
        assert_same(got, want)
    assert not bool(got.converged.all())
    assert (got.rounds == 1).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_one_phase_and_greedy_match_jax(backend):
    """The same JAX state (greedy init off, so the phase has long paths to
    find) through one phase of each package, and the greedy init."""
    adj = np.stack([_instance("perfect", s) for s in range(2)])
    state = jb._match_init(jnp.asarray(adj), greedy_init=False)
    port = to_torch(state, "cpu")
    assert isinstance(port, tb.MatchState)
    for _ in range(2):
        state = jax.jit(jb._phase, static_argnums=1)(state, backend)
        port = tb._phase(port, backend)
        assert_same(port, state)
    want = jb._greedy_match(state.adj, state.match_row, state.match_col)
    got = tb._greedy_match(port.adj, port.match_row, port.match_col)
    assert_same(tuple(got), tuple(np.asarray(x) for x in want))


def test_errors():
    adj = _instance("random")
    with pytest.raises(ValueError, match="match_bipartite_batch"):
        match_bipartite(adj[None], device="cpu")
    with pytest.raises(ValueError, match=r"\(B, nl, nr\)"):
        match_bipartite_batch(adj, device="cpu")
    with pytest.raises(ValueError, match="unknown backend 'cuda'"):
        match_bipartite(adj, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown backend 'cuda'"):
        match_bipartite_batch(adj[None], compact=True, backend="cuda",
                              device="cpu")
    one_lane = make_solver_mesh(1, device="cpu")
    with pytest.raises(ValueError, match="not in mesh axes"):
        match_bipartite_batch(adj[None], mesh=one_lane, mesh_axis="model",
                              device="cpu")
    assert_same(match_bipartite_batch(adj[None], mesh=one_lane,
                                      device="cpu"),
                match_bipartite_batch(adj[None], device="cpu"))


def test_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        match_bipartite(_instance("random"))
