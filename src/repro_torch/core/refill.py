"""Continuous batching: a per-kind refill session over ``run_compacted``.

Counterpart of ``repro/core/refill.py``. A closed compacted batch still
wastes slots: once an instance converges its slot sits idle until the
whole batch drains. ``run_compacted``'s ``refill=`` hook
(``repro_torch.core.solver_loop``) lets new instances enter vacated slots
at the cycle boundary where the host re-gathers the live set anyway, as
continuous batching does in LLM serving loops.

This module turns that hook protocol into a per-kind SESSION:

* ``RefillRuntime``: what a solver kind registers (the optional
  ``refill`` factory of ``repro_torch.core.kinds.SolverKind``): its
  ``LoopSpec`` plus the pad-one/init/finalize/crop pieces that bring a
  single request into, and out of, an in-flight batched state.
* ``RefillSolver``: one session of one kind on one fixed bucket shape:
  seed it with payloads, hand it an ``admit`` callback that supplies more
  as slots free up, and receive each request's result THE MOMENT its
  instance converges (``on_result``).

Contract: cycles are per-instance pure and every admission enters with a
fresh rounds counter through the same gather/cycle/scatter machinery, so
a refilled session delivers for EVERY request exactly the result, values
and counters, of that request's closed-batch solve at the same padding
shape. Seeds and admissions may be warm-started
(``repro_torch.core.warm.WarmStart``), the slots may split into device
lanes (``mesh=``), and a ``tracer=`` (``repro_torch.obs.Tracer``)
records one ``bucket/pad`` span per payload it takes in and one
``device-solve`` span per session, as the reference does.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.kinds import get_kind
from repro_torch.core.masking import tree_leaves, tree_map
from repro_torch.core.solver_loop import LoopSpec, run_compacted

__all__ = ["RefillRuntime", "refill_runtime", "RefillSolver"]


class RefillRuntime(NamedTuple):
    """A kind's continuous-batching registration (see module docstring).

    All callables follow the kind's PUBLIC batched layout (batch axis
    leading on every problem leaf); ``init``/``finalize`` own any internal
    re-layout (e.g. the grid solver's direction-axis move). Problems stay
    on the host (numpy); ``init`` puts the state on the solve's device.
    """

    spec: LoopSpec          # the kind's solver-loop registration
    pad_one: Callable       # (payload, bucket_shape) -> batch-1 problem
    init: Callable          # stacked problem (B leading) -> solver state
    finalize: Callable      # (batch-1 problem, state1, rounds(1,)) -> result
    crop: Callable          # (batch-1 result, orig_shape, payload) -> result
    shape_of: Callable      # validated payload -> its shape tuple


def refill_runtime(kind: str, **solver_kw) -> RefillRuntime:
    """The registered refill runtime of ``kind`` with ``solver_kw`` knobs
    (``device=`` among them).

    Raises ``ValueError`` for kinds that registered no refill factory.
    """
    k = get_kind(kind)
    if k.refill is None:
        raise ValueError(
            f"solver kind {kind!r} has no refill runtime; it serves "
            f"closed-batch only (register a SolverKind.refill factory to "
            f"enable continuous batching)")
    return k.refill(**solver_kw)


def _concat_problems(stacked1: list):
    """Concatenate batch-1 host problems along the leading batch axis."""
    if len(stacked1) == 1:
        return stacked1[0]
    return tree_map(lambda *xs: np.concatenate(xs, axis=0), *stacked1)


class RefillSolver:
    """One continuous-batching session: one kind, one bucket shape.

    Every request is padded to ``shape`` and occupies one of ``capacity``
    slots; slots not seeded, or vacated by converged instances, are offered
    back through ``admit``. Results are delivered per instance, in
    convergence order, through ``on_result``; ``run`` also returns them
    keyed by request index.

    Args:
      kind: a registered solver kind with a refill runtime
        (``maxflow`` / ``assignment`` / ``matching`` all register one).
      shape: the session bucket shape; every admitted payload must fit
        componentwise (``fits``).
      capacity: number of slots (per-cycle batch width upper bound).
      mesh / mesh_axis: optional lane set
        (``repro_torch.launch.mesh.make_solver_mesh``): the slots split
        into per-lane ranges (``compact_lanes``; ``capacity`` must divide
        evenly), admissions refill within lanes.
      tracer: optional ``repro_torch.obs.Tracer``: the session records a
        ``device-solve`` span around its run and ``bucket/pad`` spans
        for every intake (the serving engines hand their own tracer
        through here). ``None`` records nothing.
      **solver_kw: the kind's static solver knobs (``backend=``,
        ``max_rounds=``, ``device=``, ...), forwarded to the refill
        runtime factory; ``device`` defaults to the card.
    """

    def __init__(self, kind: str, *, shape, capacity: int, mesh=None,
                 mesh_axis: str | None = None, tracer=None, **solver_kw):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.kind = get_kind(kind)
        self.rt = refill_runtime(kind, **solver_kw)
        self.shape = tuple(int(s) for s in shape)
        self.capacity = int(capacity)
        self.tracer = tracer
        self._solver_kw = dict(solver_kw)
        self._warm_fn = None
        self._lanes = None
        if mesh is not None:
            from repro_torch.launch.mesh import compact_lanes
            self._lanes = compact_lanes(mesh, mesh_axis, self.capacity)

    def _warm_state1(self, problem1, payload, ws):
        """Warm per-instance state through the kind's warm seam."""
        from repro_torch.core.warm import build_warm_state
        if self.kind.warm_state is None:
            raise ValueError(
                f"solver kind {self.kind.name!r} registered no warm_state "
                f"hook; warm admissions need one")
        if self._warm_fn is None:
            self._warm_fn = self.kind.warm_state(**self._solver_kw)
        return build_warm_state(self.kind, self.rt, self._warm_fn, problem1,
                                payload, ws, self.shape)

    def fits(self, payload) -> bool:
        """Does a (validated) payload fit this session's bucket shape?"""
        s = self.rt.shape_of(payload)
        return len(s) == len(self.shape) and all(
            a <= b for a, b in zip(s, self.shape))

    def run(self, initial, *, admit: Callable | None = None,
            on_result: Callable | None = None,
            on_error: Callable | None = None,
            warm: dict | None = None) -> dict[int, Any]:
        """Drive one session to quiescence; returns ``{request_index:
        result}``.

        Request indices count every payload the session saw, in arrival
        order: ``initial`` first (0..len-1), then each payload returned by
        ``admit`` in return order.

        Args:
          initial: up to ``capacity`` seed payloads (fewer is fine: the
            remaining slots start empty and are offered to ``admit``
            before the first cycle).
          admit: optional ``admit(n_free) -> payloads`` callback, called at
            every cycle boundary with free slots; must return at most
            ``n_free`` payloads (``[]``/``None`` declines; the session ends
            when nothing is live and ``admit`` declines). Each item may be
            a bare payload or a ``(payload, WarmStart)`` pair, which admits
            the instance warm-started from its cached prior solution.
          on_result: optional ``on_result(request_index, result)``, called
            the moment that request's instance converges.
          on_error: optional ``on_error(request_index, exc)``: a payload
            that fails validation/padding/init at admission, or whose
            finalize/crop raises, fails ALONE and the session continues.
            Without ``on_error`` such failures propagate.
          warm: optional ``{seed_position: WarmStart}`` for the
            ``initial`` payloads; warm and cold seeds mix in one session
            through per-slot init.
        """
        from repro_torch.core.warm import WarmStart, _concat_states
        rt, cap, shape = self.rt, self.capacity, self.shape
        initial = list(initial)
        warm = dict(warm or {})
        if len(initial) > cap:
            raise ValueError(
                f"{len(initial)} initial payloads > capacity {cap}")
        for pos in warm:
            if not 0 <= pos < len(initial):
                raise ValueError(
                    f"warm position {pos} out of range for "
                    f"{len(initial)} initial payloads")

        results: dict[int, Any] = {}
        req_of_token: dict[int, int] = {}
        problems: dict[int, Any] = {}       # request idx -> batch-1 problem
        metas: dict[int, tuple] = {}        # request idx -> (shape, payload)
        counters = {"n_req": 0}

        def _error(idx: int, e: Exception) -> None:
            if on_error is None:
                raise e
            on_error(idx, e)

        def _intake(payload):
            """Validate + pad one payload; returns its request idx (or None
            on failure, reported through ``on_error``)."""
            idx = counters["n_req"]
            counters["n_req"] += 1
            t0 = time.monotonic() if self.tracer is not None else 0.0
            try:
                p = self.kind.validate(payload)
                if not self.fits(p):
                    raise ValueError(
                        f"payload shape {rt.shape_of(p)} does not fit "
                        f"session bucket {shape}")
                p1 = rt.pad_one(p, shape)
            except Exception as e:
                _error(idx, e)
                return None
            if self.tracer is not None:
                self.tracer.record("bucket/pad", t0, time.monotonic(),
                                   kind=self.kind.name, n=1,
                                   bucket=list(shape))
            problems[idx] = p1
            metas[idx] = (rt.shape_of(p), p)
            return idx

        # seed slots: initial payloads first, inert fill for the rest
        warmstarts: dict[int, Any] = {}     # request idx -> WarmStart
        stacked1, slot = [], 0
        for pos, payload in enumerate(initial):
            idx = _intake(payload)
            if idx is None:
                continue
            req_of_token[slot] = idx       # initial tokens are slot indices
            if pos in warm:
                warmstarts[idx] = warm[pos]
            stacked1.append(problems[idx])
            slot += 1
        for _ in range(cap - slot):
            inert = self.kind.inert_problem(shape)
            stacked1.append(tree_map(lambda a: np.asarray(a)[None], inert))
        if warmstarts:
            # mixed warm/cold seeding: per-slot init, concatenated along
            # each leaf's batch axis (init is per-instance pure)
            states1 = []
            for token, p1 in enumerate(stacked1):
                idx = req_of_token.get(token)
                if idx in warmstarts:
                    states1.append(self._warm_state1(
                        p1, metas[idx][1], warmstarts[idx]))
                else:
                    states1.append(rt.init(p1))
            state = _concat_states(rt.spec, states1)
        else:
            state = rt.init(_concat_problems(stacked1))
        session = self

        class _Hook:
            def admit(self, n_free: int):
                if admit is None:
                    return []
                out = []
                # loop: if EVERY offered payload failed intake, re-offer:
                # an empty return reads as a decline to the driver, and a
                # failed payload must not end the session while the
                # caller still has work to give
                while not out:
                    payloads = list(admit(n_free) or [])
                    if len(payloads) > n_free:
                        raise ValueError(
                            f"admit({n_free}) returned {len(payloads)} "
                            f"payloads; it must return at most n_free")
                    if not payloads:           # a genuine decline
                        break
                    for item in payloads:
                        ws = None
                        if (isinstance(item, tuple) and len(item) == 2
                                and isinstance(item[1], WarmStart)):
                            item, ws = item
                        idx = _intake(item)
                        if idx is None:
                            continue
                        try:
                            if ws is not None:
                                st1 = session._warm_state1(
                                    problems[idx], metas[idx][1], ws)
                            else:
                                st1 = rt.init(problems[idx])
                        except Exception as e:
                            _error(idx, e)
                            continue
                        token = cap + idx   # disjoint from the slot tokens
                        req_of_token[token] = idx
                        out.append((token, st1))
                return out

            def emit(self, token, st1, r: int):
                idx = req_of_token.get(token)
                if idx is None:            # an inert fill slot, no request
                    return
                try:
                    dev = tree_leaves(st1)[0].device
                    res1 = rt.finalize(problems[idx], st1, torch.full(
                        (1,), r, dtype=torch.int32, device=dev))
                    res = rt.crop(res1, *metas[idx])
                except Exception as e:
                    _error(idx, e)
                    return
                results[idx] = res
                if on_result is not None:
                    on_result(idx, res)

        span = (contextlib.nullcontext() if self.tracer is None else
                self.tracer.span("device-solve", kind=self.kind.name,
                                 bucket=list(shape), capacity=cap,
                                 driver="refill"))
        with span:
            run_compacted(rt.spec, state, cap, lanes=self._lanes,
                          refill=_Hook())
        return results
