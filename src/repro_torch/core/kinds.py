"""Solver-kind registry: the one seam every layer above the kernels shares.

Counterpart of ``repro/core/kinds.py``, copied whole: the registry imports
no solver and no array library. The layers above the solvers (the ragged
pad-and-bucket front end ``repro_torch.core.batch``, continuous batching
``repro_torch.core.refill``, and later the serving engines) dispatch
through ``get_kind`` instead of hardcoding the kinds. A solver kind
registers once, under a string name, the capabilities those layers need.
The port registers the paper's two solvers (``repro_torch.core.batch``)
and bipartite matching (``repro_torch.core.matching``, after Deveci et
al., arXiv:1303.1379).

A ``SolverKind`` bundles:

* ``validate(payload) -> payload``: canonicalize + reject a malformed
  request (raises ``ValueError``) before it is queued.
* ``inert_problem(shape) -> payload``: an instance that converges
  immediately and cannot perturb batch-mates (the refill session's empty
  slots; the reference also pads mesh shards with it).
* ``prepare_buckets(payloads, *, bucket=, mesh=, mesh_axis=)``: the HOST
  stage: pad, bucket, and stack a ragged queue into ``PreparedBucket``s.
* ``solve_prepared(prep, *, compact=, mesh=, mesh_axis=, **kw)``: the
  DEVICE stage: one batched dispatch of a prepared bucket, returning
  ``({payload_position: result}, BucketStats)``.
* ``loop_spec(**static_kw) -> LoopSpec``: the kind's cached ``LoopSpec``
  factory (``repro_torch.core.solver_loop``).
* ``refill(**static_kw) -> RefillRuntime``: OPTIONAL (default ``None``):
  the kind's continuous-batching runtime (``repro_torch.core.refill``),
  the pad-one/init/finalize/crop pieces that let new instances of this
  kind enter an in-flight compacted solve at cycle boundaries.

Three further OPTIONAL hooks form the warm-start seam of the reference
(``repro/core/warm.py``): ``init_state``, ``warm_state`` and
``solution_of``; ``repro_torch.core.warm`` drives them, and every
built-in kind registers all three.

The built-in kinds register themselves when their home modules import;
``get_kind`` / ``registered_kinds`` lazily import those modules so lookups
work no matter which module the caller imported first.
"""
from __future__ import annotations

import importlib
from typing import Any, Callable, NamedTuple

__all__ = ["SolverKind", "register_kind", "get_kind", "registered_kinds"]


class SolverKind(NamedTuple):
    """One solver kind's registration — see the module docstring."""

    name: str
    validate: Callable[[Any], Any]
    inert_problem: Callable[..., Any]
    prepare_buckets: Callable[..., list]
    solve_prepared: Callable[..., tuple]
    loop_spec: Callable[..., Any]
    # optional: the kind's continuous-batching runtime factory
    # (repro_torch.core.refill.RefillRuntime); None = closed-batch only
    refill: Callable[..., Any] | None = None
    # optional warm-start seam (repro_torch.core.warm); None = cold-only.
    # init_state / warm_state are factories over the kind's static solver
    # knobs returning per-instance (batch-1) state builders; solution_of
    # maps one cropped result to its cacheable artifact.
    init_state: Callable[..., Any] | None = None
    warm_state: Callable[..., Any] | None = None
    solution_of: Callable[[Any], Any] | None = None


_REGISTRY: dict[str, SolverKind] = {}

# Modules that register the built-in kinds as an import side effect.  Lazy
# (imported on first lookup, not at this module's import) so the registry
# itself never drags the solvers in, and so circular imports cannot form:
# these modules import ``repro_torch.core.kinds`` at their top, we import
# them only
# from inside a function call.
_BUILTIN_MODULES = ("repro_torch.core.batch",
                    "repro_torch.core.matching")


def _ensure_builtins() -> None:
    for mod in _BUILTIN_MODULES:
        importlib.import_module(mod)


def register_kind(kind: SolverKind) -> SolverKind:
    """Register ``kind`` under ``kind.name``; returns it for convenience.

    Duplicate names are an error (a silent overwrite would let two modules
    fight over a name and make dispatch order-of-import dependent).  There
    is deliberately no unregister: kinds are process-lifetime registrations,
    like pytree registrations.
    """
    if not kind.name or not isinstance(kind.name, str):
        raise ValueError(f"kind name must be a non-empty string, "
                         f"got {kind.name!r}")
    if kind.name in _REGISTRY:
        raise ValueError(
            f"solver kind {kind.name!r} is already registered; kind names "
            f"must be unique (registered: {sorted(_REGISTRY)})")
    _REGISTRY[kind.name] = kind
    return kind


def get_kind(name: str) -> SolverKind:
    """Look up a registered kind; unknown names raise naming the known ones."""
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown solver kind {name!r}; registered kinds: "
            f"{', '.join(registered_kinds())}") from None


def registered_kinds(*, ensure: bool = True) -> tuple[str, ...]:
    """Names of every registered kind, in registration order.

    Built-in kinds (``maxflow``, ``assignment``, ``matching``) are ensured
    first, so the result is stable regardless of which module the caller
    imported.  Pass ``ensure=False`` to only PEEK at what has registered so
    far without importing the builtin solver modules.
    """
    if ensure:
        _ensure_builtins()
    return tuple(_REGISTRY)
