"""Round counts of the JAX package on the smoke run's instances.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_smoke_constants.py

``chip_smoke.py`` runs where JAX is not installed, so the counts it holds
the port to (``ASSIGN_ROUNDS_WANT``, ``MATCH_ROUNDS_WANT``) are module
constants. This script makes them: it solves the same instances
(``chip_smoke.assignment_weights`` and ``chip_smoke.matching_adjacency``)
with the JAX package on the CPU, one instance at a time (a batch equals a
loop of single solves, and one instance keeps the memory small), checks
each answer against its oracle and prints the two constants. Counts do
not depend on the machine. It takes a few minutes.
"""
import pathlib
import sys
import time

import jax.numpy as jnp

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro.core.assignment.cost_scaling import solve_assignment  # noqa: E402
from repro.core.matching.bfs import match_bipartite  # noqa: E402
from repro_torch.core.assignment.ref import optimal_weight  # noqa: E402
from repro_torch.core.matching.ref import hopcroft_karp  # noqa: E402


def main() -> None:
    t0 = time.perf_counter()
    w = chip_smoke.assignment_weights()
    assign = {}
    for method in ("auction", "pushrelabel"):
        rounds = []
        for i in range(w.shape[0]):
            res = solve_assignment(jnp.asarray(w[i], jnp.int32),
                                   method=method)
            assert bool(res.converged), (method, i)
            assert int(res.weight) == optimal_weight(w[i]), (method, i)
            rounds.append(int(res.rounds))
            print(f"# assignment {method} instance {i}: rounds "
                  f"{rounds[-1]}, weight {int(res.weight)} "
                  f"({time.perf_counter() - t0:.0f} s)", flush=True)
        assign[method] = tuple(rounds)
    adj = chip_smoke.matching_adjacency()
    match = []
    for i in range(adj.shape[0]):
        res = match_bipartite(jnp.asarray(adj[i]))
        assert bool(res.converged), i
        assert int(res.cardinality) == hopcroft_karp(adj[i])[2], i
        match.append(int(res.rounds))
        print(f"# matching instance {i}: phases {match[-1]}, cardinality "
              f"{int(res.cardinality)} ({time.perf_counter() - t0:.0f} s)",
              flush=True)
    print(f"ASSIGN_ROUNDS_WANT = {assign!r}")
    print(f"MATCH_ROUNDS_WANT = {tuple(match)!r}")


if __name__ == "__main__":
    main()
