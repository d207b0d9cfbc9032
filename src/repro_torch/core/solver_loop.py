"""Solver-loop runtime, masked half: ``LoopSpec`` and ``run_masked``.

Counterpart of the masked driver of ``repro/core/solver_loop.py``. A
solver registers one heuristic cycle as a ``LoopSpec``:

* ``cycle(state) -> state``: one heuristic cycle, batch-polymorphic and
  PER-INSTANCE PURE (instance ``b`` of the output depends only on
  instance ``b`` of the input),
* ``live(state, rounds) -> (...,) bool``: the per-instance liveness mask,
* ``rounds_per_cycle``: the per-instance round-accounting increment,
* ``lead_axes_fn(leaf, batch_ndim) -> int``: how many leaf axes PRECEDE
  the batch axes (``None`` = batch leads every leaf).

The reference runs the loop on the device as a ``lax.while_loop``. Here it
is a host loop with the same cond-before-body structure and ONE liveness
sync per cycle. Early-exit compaction, refill and cycle telemetry are the
other half of the reference module and come with ROADMAP item M3.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.masking import freeze


class LoopSpec(NamedTuple):
    """A solver's registration with the loop runtime."""

    cycle: Callable        # state -> state, one heuristic cycle (all-live)
    live: Callable         # (state, rounds) -> (...,) bool per instance
    rounds_per_cycle: int
    lead_axes_fn: Callable | None = None   # (leaf, batch_ndim) -> int


def _lead(spec: LoopSpec, batch_ndim: int):
    """Adapt the spec's (leaf, batch_ndim) signature to a (leaf,) closure."""
    if spec.lead_axes_fn is None:
        return None
    fn = spec.lead_axes_fn
    return lambda a: fn(a, batch_ndim)


def run_masked(spec: LoopSpec, state, batch_shape: tuple):
    """Masked iteration: cycle the whole batch, freeze non-live instances.

    With ``batch_shape == ()`` the mask is the scalar predicate of a
    single-instance loop, so single and batched solves share one
    trajectory. Returns ``(state, rounds)`` where ``rounds`` (int32, the
    batch shape) counts, per instance, the rounds executed while that
    instance was live.
    """
    lead = _lead(spec, len(batch_shape))
    rounds = torch.zeros(batch_shape, dtype=torch.int32,
                         device=state[0].device)
    while True:
        lv = spec.live(state, rounds)
        if not bool(lv.any()):         # the one host sync of the cycle
            return state, rounds
        state = freeze(lv, spec.cycle(state), state, lead_axes_fn=lead)
        rounds = rounds + torch.where(lv, spec.rounds_per_cycle, 0).to(
            torch.int32)
