"""Public surface of the port's solver core (counterpart of
``repro/core/__init__.py``; ``__all__`` holds the same names).

* ``maxflow_grid`` / ``maxflow_grid_batch``: push-relabel max-flow /
  min-cut on 2-D grid graphs (paper §4), one instance or ``(B, 4, H, W)``
  stacks with per-instance convergence.
* ``solve_assignment``: cost-scaling max-weight perfect matching (paper
  §5), ``(n, n)`` or ``(B, n, n)``.
* ``match_bipartite`` / ``match_bipartite_batch``: maximum-cardinality
  bipartite matching via lock-free BFS augmenting-path phases.
* ``SolverKind`` / ``register_kind`` / ``get_kind`` / ``registered_kinds``:
  the solver-kind registry (``repro_torch.core.kinds``), the one seam the
  batch front end and refill sessions dispatch through.
* ``solve_batch`` / ``prepare_buckets`` / ``solve_prepared``: the generic
  pad-and-bucket front end for ragged collections of any registered kind
  (``repro_torch.core.batch``); ``solve_maxflow_batch`` /
  ``solve_assignment_batch`` are its per-kind spellings.
* ``freeze``: the per-instance liveness select behind batched solving.
* ``LoopSpec`` / ``run_masked`` / ``run_compacted`` / ``cycle_events`` /
  ``CycleEvent`` / ``trace_cycles``: the solver-loop runtime (masked
  iteration, early-exit compaction, per-cycle telemetry), shared by every
  kind.
* ``PreparedBucket`` / ``BucketStats``: the host-stage hand-off and the
  per-solve occupancy/round-spread record (``stats_out=``).

The batched entry points take ``compact=`` (early-exit compaction),
``device=`` (the card unless ``"cpu"``) and ``mesh=`` (device lanes,
``repro_torch.launch.mesh``); ``solve_batch`` also takes ``warm=``
(``repro_torch.core.warm``: warm starts, graph deltas and the solution
cache). ``repro_torch.core.refill`` holds the continuous-batching
session ``RefillSolver``.
"""
from repro_torch.core.assignment.cost_scaling import (AssignmentResult,
                                                      solve_assignment)
from repro_torch.core.batch import (BucketStats, PreparedBucket,
                                    prepare_buckets, solve_assignment_batch,
                                    solve_batch, solve_maxflow_batch,
                                    solve_prepared)
from repro_torch.core.kinds import (SolverKind, get_kind, register_kind,
                                    registered_kinds)
from repro_torch.core.masking import freeze
from repro_torch.core.matching import (MatchingResult, match_bipartite,
                                       match_bipartite_batch)
from repro_torch.core.maxflow.grid import (GridFlowResult, GridProblem,
                                           maxflow_grid, maxflow_grid_batch)
from repro_torch.core.solver_loop import (CycleEvent, LoopSpec,
                                          cycle_events, run_compacted,
                                          run_masked, trace_cycles)

__all__ = [
    "AssignmentResult",
    "BucketStats",
    "CycleEvent",
    "GridFlowResult",
    "GridProblem",
    "LoopSpec",
    "MatchingResult",
    "PreparedBucket",
    "SolverKind",
    "cycle_events",
    "freeze",
    "get_kind",
    "match_bipartite",
    "match_bipartite_batch",
    "maxflow_grid",
    "maxflow_grid_batch",
    "prepare_buckets",
    "register_kind",
    "registered_kinds",
    "run_compacted",
    "run_masked",
    "solve_assignment",
    "solve_assignment_batch",
    "solve_batch",
    "solve_maxflow_batch",
    "solve_prepared",
    "trace_cycles",
]
