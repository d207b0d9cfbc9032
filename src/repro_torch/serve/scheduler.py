"""Async serving scheduler: background-flush SolverEngine with futures.

Counterpart of ``repro/serve/scheduler.py``. The blocking serve path
(``repro_torch.serve.engine.SolverEngine``) solves nothing until a caller
flushes, and while it pads the next queue the device idles. This module
puts a SCHEDULER in front of the same synchronous core:

* ``AsyncSolverEngine.submit(kind, payload)`` may be called from any
  thread, for any kind registered with ``repro_torch.core.kinds``, and
  returns a ``concurrent.futures.Future``;
* a background scheduler thread flushes a kind when its queue reaches
  ``max_batch`` (size trigger) or the oldest request's deadline expires
  (deadline trigger, per-request ``deadline_ms`` with ``max_delay_ms`` as
  the default): no manual flush is ever needed;
* flushed batches run through a TWO-STAGE pipeline: the scheduler thread
  does the host pad-and-bucket (``SolverEngine.prepare``, numpy) of batch
  *k+1* while a lane thread runs the device solve
  (``SolverEngine.solve_prepared``) of batch *k*. Lanes are
  double-buffered (``n_lanes``, bounded hand-off queues: one staged and
  one in-flight dispatch per lane); on a lane set of several cards each
  lane takes a disjoint sub-set (``repro_torch.launch.mesh.
  scheduler_lanes``), and on one card each lane owns a CUDA stream of its
  own (below), so two batches can be in flight on the card at once;
* per dispatch the scheduler picks the MASKED or COMPACTED solver-loop
  driver adaptively from the EWMA of recent batches' convergence spread,
  tracked PER KIND (``repro_torch.serve.metrics.ConvergenceStats``;
  ``dispatch=`` forces either driver);
* with ``refill=True`` a flushed batch becomes a CONTINUOUS-BATCHING
  session (``repro_torch.core.refill.RefillSolver``): queued requests of
  the same kind that fit the session's bucket shape are admitted into
  slots vacated by converged instances at every cycle boundary, and each
  ticket's future resolves the moment ITS instance converges. Kinds
  without a registered refill runtime serve closed-batch; and
* every result is bit-identical to the synchronous ``flush()`` of the
  same queue: the scheduler only decides WHEN and ON WHICH LANE the
  tested batch path runs, never what it computes
  (tests/test_torch_scheduler.py).

Lanes and streams. The reference gives each lane a disjoint sub-mesh of
TPU cores. The port's counterpart on one card is a CUDA stream per lane:
a lane thread runs its whole device stage under ``torch.cuda.stream``
of its own stream (the current stream is per thread), so the kernels
and copies it launches queue there, and a host sync inside its cycle
(``.item()``, a liveness read) waits for that lane's work alone, not for
the other lane's. With ``n_lanes=1`` the batches run one after another
on one stream. On the CPU a lane has no stream and the code path is
otherwise the same. Two hazards are handled here:

* The prepared bucket is numpy; ``solve_prepared`` copies it to the card
  on the lane thread, so the copy is enqueued on the lane's own stream
  ahead of every kernel that reads it.
* A result made on a lane's stream is read by the caller on another
  stream, and a cached solution by another lane's stream (warm
  requests). The lane SYNCHRONISES its stream before it resolves a
  future or caches a solution, so the values are final when anyone can
  see them, and it calls ``record_stream`` on every result tensor for
  each card's default stream and every lane's stream, so the caching
  allocator hands the memory back to the lane only after the work those
  streams had queued when the result was freed. Synchronising alone
  would leave that second race open: the allocator reuses a freed block
  on its own stream at once. A caller reading results on a stream of its
  own records it there itself, as PyTorch asks of any cross-stream use.

The scheduler itself is kind-agnostic: queues, triggers, EWMAs and lane
dispatch are keyed by the kind names that actually arrive.

Failure semantics: requests are validated BEFORE a future exists (the
sync engine's contract); if a batched dispatch still fails, the lane
solves that batch's requests again one at a time through the same path,
so a poisoned request fails ONLY its own future. ``close(drain=True)``
(also the context-manager exit) solves everything pending before
returning; ``close(drain=False)`` cancels queued futures
(``Future.cancelled()``) and only finishes batches already in flight.
Neither path can hang on a quiet queue.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import queue
import threading
import time
import warnings
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.core.batch import _bucket_shape
from repro_torch.core.kinds import get_kind
from repro_torch.core.masking import tree_leaves
from repro_torch.core.refill import refill_runtime
from repro_torch.core.solver_loop import trace_cycles
from repro_torch.launch.mesh import scheduler_lanes, shard_count
from repro_torch.obs.trace import current_tracer
from repro_torch.serve.engine import (SolverEngine, _check_no_device,
                                      _merge_deprecated_kw)
from repro_torch.serve.metrics import SchedulerMetrics

_SENTINEL = object()


@dataclass
class _Request:
    ticket: int
    kind: str
    payload: Any
    future: Future
    submit_t: float
    deadline_t: float
    queued_t: float = 0.0     # enqueue timestamp (queue-wait span start)
    warm: Any = None          # WarmStart seed (submit(base=/delta=)) or None


def _cards(devices) -> list:
    """The distinct CUDA devices among ``devices``, each with its index."""
    out = []
    for d in devices:
        if d.type == "cuda":
            d = torch.device("cuda", torch.cuda.current_device()
                             if d.index is None else d.index)
            if d not in out:
                out.append(d)
    return out


@dataclass
class _Lane:
    """One dispatch lane: its own SolverEngine (lane set), its own CUDA
    stream on each card it solves on (none on the CPU), a worker thread."""
    engine: SolverEngine
    streams: tuple = ()
    work: "queue.Queue[Any]" = field(
        default_factory=lambda: queue.Queue(maxsize=1))
    thread: threading.Thread | None = None

    def on_streams(self) -> contextlib.ExitStack:
        """Make the lane's streams current on this thread, each on its
        card, for the ``with`` body."""
        stack = contextlib.ExitStack()
        for s in self.streams:
            stack.enter_context(torch.cuda.stream(s))
        return stack


def choose_driver(spread_ewma: float | None, n_real: int, *,
                  threshold: float, min_batch: int,
                  forced: str = "adaptive") -> bool:
    """Masked or compacted for the next dispatch? Returns ``compact``.

    ``forced`` short-circuits (``"masked"`` / ``"compacted"`` — the
    override knob). Adaptively, compaction is chosen once the observed
    convergence-spread EWMA clears ``threshold`` AND the bucket is big
    enough to amortize the host-driven gather/scatter loop
    (``min_batch``); with no history yet (EWMA ``None``) the masked
    single-dispatch driver is the safe default.
    """
    if forced == "masked":
        return False
    if forced == "compacted":
        return True
    if forced != "adaptive":
        raise ValueError(
            f"dispatch must be 'adaptive' | 'masked' | 'compacted', "
            f"got {forced!r}")
    return (spread_ewma is not None and spread_ewma > threshold
            and n_real >= min_batch)


def _refill_groups(rt, bucket: str, reqs: list) -> list[tuple[tuple, list]]:
    """Group a popped batch by session bucket shape.

    The continuous-batching analogue of the kind's ``prepare_buckets``
    policy: one refill session per bucket shape (``"max"`` → one session
    at the componentwise max; ``"pow2"`` / ``"exact"`` → one per rounded /
    exact shape), so every instance a session ever holds shares one
    compiled cycle ladder.
    """
    shapes = [rt.shape_of(r.payload) for r in reqs]
    max_shape = tuple(max(s[d] for s in shapes)
                      for d in range(len(shapes[0])))
    groups: dict[tuple, list] = {}
    for r, s in zip(reqs, shapes):
        groups.setdefault(_bucket_shape(s, bucket, max_shape), []).append(r)
    return list(groups.items())


class AsyncSolverEngine:
    """Background-flush solver serving: submit from any thread, get futures.

    Args:
      device: where every kind solves (``repro_torch.resolve_device``:
        the card unless ``"cpu"``), forwarded to the lane engines;
        ``solver_kw`` may name no device.
      max_batch: size trigger — a kind flushes as soon as ``max_batch`` of
        its requests are queued (also the per-dispatch batch cap, so one
        flush of a long queue becomes several max-occupancy batches).
      max_delay_ms: default deadline budget — a request never waits longer
        than this for batch-mates before its kind is flushed
        (per-request ``deadline_ms`` overrides).
      dispatch: ``"adaptive"`` (default) picks masked vs compacted per
        dispatch from the convergence-spread EWMA; ``"masked"`` /
        ``"compacted"`` force one driver (the override knob).
      spread_threshold / min_compact_batch / ewma_alpha: adaptive-policy
        tuning — see ``choose_driver`` / ``repro_torch.serve.metrics``.
      refill: continuous batching (default off). A flushed batch of a
        kind with a registered refill runtime (``SolverKind.refill``)
        becomes a ``repro_torch.core.refill.RefillSolver`` session: slots
        freed by converged instances are refilled MID-SOLVE from the
        kind's pending queue (requests must fit the session's bucket
        shape), and futures resolve per instance as each converges.
        Results stay bit-identical to the closed-batch path; kinds
        without a refill runtime serve closed-batch as before.
      n_lanes: dispatch lanes for the host/device pipeline (2 =
        double-buffered). Each lane solves on a CUDA stream of its own on
        every card it uses (module docstring); on a lane set of at least
        ``n_lanes`` devices each lane also owns a disjoint sub-set
        (``repro_torch.launch.mesh.scheduler_lanes``).
      mesh / mesh_axis / bucket / solver_kw: forwarded to the per-lane
        ``SolverEngine`` cores (same semantics as the blocking engine);
        ``solver_kw`` is keyed by kind name.
      maxflow_kw / assignment_kw: DEPRECATED — folded into ``solver_kw``
        with a ``DeprecationWarning``.
      metrics: optional ``SchedulerMetrics`` to record into (one is
        created otherwise; read it via ``.metrics.snapshot()``).
      tracer: optional ``repro_torch.obs.Tracer`` recording per-ticket
        lifecycle spans (``submit`` → ``queue-wait`` → ``bucket/pad`` →
        ``device-solve`` → ``refill-admission`` → ``resolve``, every span
        tagged ``ticket``/``kind``). Defaults to the AMBIENT tracer at
        construction (``repro_torch.obs.use_tracer``), captured once here
        and handed to the lane engines, because contextvars do not cross into
        the scheduler/lane threads. ``None`` traces nothing; the hot path
        then pays one ``None`` check per stage.

    Results are bit-identical to ``SolverEngine.flush()`` of the same
    request stream chunked the same way — and, transitively, to a loop of
    single solves (tests/test_torch_scheduler.py).
    """

    def __init__(self, *, device=None, max_batch: int = 16,
                 max_delay_ms: float = 50.0,
                 dispatch: str = "adaptive", spread_threshold: float = 0.25,
                 min_compact_batch: int = 4, ewma_alpha: float = 0.25,
                 refill: bool = False,
                 n_lanes: int = 2, mesh=None, mesh_axis: str | None = None,
                 bucket: str = "max",
                 solver_kw: dict[str, dict] | None = None,
                 maxflow_kw: dict | None = None,
                 assignment_kw: dict | None = None,
                 metrics: SchedulerMetrics | None = None,
                 tracer=None, cache=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_delay_ms <= 0:
            raise ValueError(
                f"max_delay_ms must be > 0, got {max_delay_ms}")
        choose_driver(None, 0, threshold=spread_threshold,
                      min_batch=min_compact_batch, forced=dispatch)
        self.max_batch = max_batch
        self.max_delay_ms = max_delay_ms
        self.dispatch = dispatch
        self.spread_threshold = spread_threshold
        self.min_compact_batch = min_compact_batch
        self.metrics = metrics or SchedulerMetrics(ewma_alpha=ewma_alpha)
        self.refill = bool(refill)
        self._bucket = bucket
        self.tracer = tracer if tracer is not None else current_tracer()
        self.device = resolve_device(device)

        solver_kw = _merge_deprecated_kw(
            solver_kw, maxflow_kw, assignment_kw, "AsyncSolverEngine")
        _check_no_device(solver_kw, "AsyncSolverEngine")
        self._solver_kw = solver_kw
        # ONE solution cache shared across every lane engine — warm
        # submissions must find solutions regardless of which lane solved
        # the base request (SolutionCache is thread-safe)
        from repro_torch.core.warm import SolutionCache
        self._cache = cache if cache is not None else SolutionCache()
        # scheduler ticket -> (kind, cache key) of its cached solution
        self._key_of_ticket: dict[int, tuple[str, str]] = {}
        # kind -> RefillRuntime | None (None = closed-batch only), lazy
        self._refill_rts: dict[str, Any] = {}
        self._lanes = [
            _Lane(engine=SolverEngine(
                device=self.device, mesh=lane_mesh, mesh_axis=mesh_axis,
                bucket=bucket, solver_kw=solver_kw, tracer=self.tracer,
                cache=self._cache),
                streams=tuple(torch.cuda.Stream(d) for d in _cards(
                    (self.device,) if lane_mesh is None
                    else lane_mesh.devices)))
            for lane_mesh in scheduler_lanes(mesh, mesh_axis, n_lanes)]
        # the streams a delivered result may be read on: each card's
        # default stream (the caller's, unless it chose another) and every
        # lane's (warm requests read cached solutions); see _settle
        self._readers = tuple(
            [torch.cuda.default_stream(d) for d in _cards(
                [self.device, *(mesh.devices if mesh is not None else ())])]
            + [s for lane in self._lanes for s in lane.streams])
        self._rr = itertools.cycle(range(len(self._lanes)))

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # per-kind FIFO queues, keyed lazily by the kinds that actually
        # arrive (insertion order fixes the flush order across kinds)
        self._pending: dict[str, collections.deque[_Request]] = {}
        self._next_ticket = 0
        self._manual = False
        self._closing = False
        self._closed = False

        self._scheduler = threading.Thread(
            target=self._scheduler_loop, name="solver-scheduler",
            daemon=True)
        self._scheduler.start()
        for i, lane in enumerate(self._lanes):
            lane.thread = threading.Thread(
                target=self._lane_loop, args=(lane,),
                name=f"solver-lane-{i}", daemon=True)
            lane.thread.start()

    # ---- submission ------------------------------------------------------

    def _resolve_base(self, kind: str, base):
        """``submit(base=)`` -> ``(base_problem, solution)`` or ``KeyError``.

        ``base`` is a prior ticket of THIS scheduler (int) or a
        ``SolutionCache`` content key (str); the lookup hit/miss is
        recorded (``warm`` metrics key).
        """
        if isinstance(base, int):
            with self._lock:
                mapped = self._key_of_ticket.get(base)
            if mapped is None or mapped[0] != kind:
                self.metrics.record_cache_lookup(False)
                raise KeyError(
                    f"base ticket {base} has no cached {kind!r} solution "
                    f"(unsolved, evicted, or a different kind)")
            base = mapped[1]
        hit = self._cache.get(base)
        self.metrics.record_cache_lookup(hit is not None)
        if hit is None:
            raise KeyError(
                f"no cached solution under key {base!r} (evicted?)")
        return hit.problem, hit.solution

    def _cache_result(self, kind: str, req: "_Request", res) -> None:
        """Cache a resolved request's solution so its ticket can seed a
        later ``submit(base=ticket)`` (kinds with a ``solution_of`` hook)."""
        k = get_kind(kind)
        if res is None or k.solution_of is None:
            return
        key = self._cache.put(kind, req.payload, k.solution_of(res))
        with self._lock:
            self._key_of_ticket[req.ticket] = (kind, key)

    def submit(self, kind: str, payload=None, *,
               deadline_ms: float | None = None,
               base=None, delta=None) -> Future:
        """Queue one request of a registered kind; returns a Future.

        Validation happens HERE, synchronously, via the kind's registered
        validator — a rejected payload (or an unknown kind) raises
        ``ValueError`` and no future is created. ``future.result()`` is
        the same result the blocking engine's ``flush`` would return for
        this request.

        Incremental re-solve: ``base=`` — a prior
        ticket of this scheduler or a ``SolutionCache`` key — warm-starts
        from that solved instance; ``delta`` (a ``GraphDelta`` or
        sequence) derives the new payload from the base problem when
        ``payload`` is ``None``. A ``base`` with no cached solution
        raises ``KeyError`` synchronously (retry with a cold submit).
        Warm requests batch, refill, and fail-isolate exactly like cold
        ones; they reach the same optima.
        """
        t0 = time.monotonic()
        ws = None
        if base is not None:
            from repro_torch.core.warm import WarmStart, apply_delta
            bp, solution = self._resolve_base(kind, base)
            if payload is None:
                if delta is None:
                    raise ValueError(
                        "submit(base=...) needs a payload or a delta to "
                        "derive one")
                payload = apply_delta(kind, bp, delta)
            elif delta is not None:
                payload = apply_delta(kind, payload, delta)
            ws = WarmStart(solution, base_problem=bp)
        elif delta is not None:
            raise ValueError("submit(delta=...) needs base= to apply it to")
        elif payload is None:
            raise ValueError("submit() needs a payload (or base=/delta=)")
        payload = get_kind(kind).validate(payload)
        now = time.monotonic()
        budget = self.max_delay_ms if deadline_ms is None else deadline_ms
        if budget <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        fut: Future = Future()
        with self._cond:
            if self._closing:
                raise RuntimeError(
                    "AsyncSolverEngine is closed; no new submissions")
            req = _Request(ticket=self._next_ticket, kind=kind,
                           payload=payload, future=fut, submit_t=now,
                           deadline_t=now + budget / 1e3,
                           queued_t=time.monotonic(), warm=ws)
            self._next_ticket += 1
            self._pending.setdefault(kind, collections.deque()).append(req)
            self.metrics.record_submit(self._depth_locked())
            self._cond.notify_all()
        if self.tracer is not None:
            # submit ends exactly where queue-wait begins (queued_t), so a
            # ticket's lifecycle spans chain without gaps or overlaps
            self.tracer.record("submit", t0, req.queued_t,
                               ticket=req.ticket, kind=kind,
                               init="warm" if ws is not None else "cold")
        return fut

    def submit_maxflow(self, problem, *,
                       deadline_ms: float | None = None) -> Future:
        """DEPRECATED: use ``submit("maxflow", problem)``."""
        warnings.warn(
            'submit_maxflow(...) is deprecated; use submit("maxflow", ...)',
            DeprecationWarning, stacklevel=2)
        return self.submit("maxflow", problem, deadline_ms=deadline_ms)

    def submit_assignment(self, w, *,
                          deadline_ms: float | None = None) -> Future:
        """DEPRECATED: use ``submit("assignment", w)``."""
        warnings.warn(
            'submit_assignment(...) is deprecated; use '
            'submit("assignment", ...)', DeprecationWarning, stacklevel=2)
        return self.submit("assignment", w, deadline_ms=deadline_ms)

    def flush_now(self) -> None:
        """Manual trigger: flush everything pending without waiting.

        A no-op on an empty queue — the flag must not stay armed, or the
        NEXT lone submission would dispatch as a singleton batch instead
        of waiting for batch-mates.
        """
        with self._cond:
            if self._depth_locked() > 0:
                self._manual = True
                self._cond.notify_all()

    def pending(self) -> int:
        """Requests queued but not yet handed to a dispatch lane."""
        with self._lock:
            return self._depth_locked()

    def _depth_locked(self) -> int:
        return sum(len(q) for q in self._pending.values())

    # ---- scheduler thread: triggers + the host half of the pipeline -----

    def _next_deadline_locked(self) -> float | None:
        ds = [r.deadline_t for q in self._pending.values() for r in q]
        return min(ds) if ds else None

    def _trigger_ready_locked(self, now: float) -> bool:
        if self._manual or self._closing:
            return self._depth_locked() > 0
        if any(len(q) >= self.max_batch for q in self._pending.values()):
            return True
        nd = self._next_deadline_locked()
        return nd is not None and nd <= now

    def _pop_batches_locked(self, now: float) -> list[tuple]:
        """Pop every batch whose trigger fired: ``(kind, reqs, trigger)``.

        Size triggers pop exactly ``max_batch`` oldest requests (FIFO =
        ticket order); a deadline/manual/drain trigger flushes the whole
        kind in ``max_batch``-sized chunks so one expired request cannot
        strand its batch-mates.
        """
        batches = []
        for kind in list(self._pending):
            q = self._pending[kind]
            while len(q) >= self.max_batch:
                batches.append((kind, [q.popleft()
                                       for _ in range(self.max_batch)],
                                "size"))
            if q and (self._closing or self._manual
                      or min(r.deadline_t for r in q) <= now):
                trigger = ("drain" if self._closing else
                           "manual" if self._manual else "deadline")
                while q:
                    chunk = [q.popleft()
                             for _ in range(min(self.max_batch, len(q)))]
                    batches.append((kind, chunk, trigger))
        self._manual = False
        return batches

    def _scheduler_loop(self) -> None:
        while True:
            with self._cond:
                now = time.monotonic()
                while not self._trigger_ready_locked(now):
                    if self._closing:      # closing + nothing pending: done
                        return
                    nd = self._next_deadline_locked()
                    self._cond.wait(
                        timeout=None if nd is None else max(nd - now, 0.0))
                    now = time.monotonic()
                batches = self._pop_batches_locked(now)
                depth = self._depth_locked()
            t_pop = time.monotonic()
            for kind, reqs, trigger in batches:
                self.metrics.record_flush(trigger, depth)
                # drop requests whose future the caller already cancelled
                live = [r for r in reqs
                        if r.future.set_running_or_notify_cancel()]
                self.metrics.record_cancelled(len(reqs) - len(live))
                if not live:
                    continue
                if self.tracer is not None:
                    for r in live:
                        self.tracer.record("queue-wait", r.queued_t, t_pop,
                                           ticket=r.ticket, kind=kind,
                                           trigger=trigger)
                rt = self._refill_rt(kind) if self.refill else None
                if rt is not None:
                    # continuous batching: one session per bucket shape,
                    # admission happens inside the lane at cycle boundaries
                    # (warm seeds/admissions ride through the session's
                    # warm= / (payload, WarmStart) forms)
                    for bshape, group in _refill_groups(
                            rt, self._bucket, live):
                        lane = self._lanes[next(self._rr)]
                        lane.work.put(("refill", kind, group, bshape))
                    continue
                if any(r.warm is not None for r in live):
                    # warm-seeded batches build per-instance states, so
                    # they skip the shared prepare stage and route whole
                    # through the warm seam (repro_torch.core.warm.solve_warm)
                    lane = self._lanes[next(self._rr)]
                    lane.work.put(("warm", kind, live, None))
                    continue
                lane = self._lanes[next(self._rr)]
                try:
                    # HOST stage: pad-and-bucket (overlaps the device solve
                    # of whatever this lane is already running)
                    preps = lane.engine.prepare(
                        kind, [r.payload for r in live])
                except Exception as e:        # can't prepare: fail the batch
                    for r in live:
                        r.future.set_exception(e)
                        self.metrics.record_done(0.0, ok=False)
                    continue
                # blocks when the lane already holds a staged batch —
                # bounded hand-off, one staged + one in-flight per lane
                lane.work.put(("batch", kind, live, preps))

    # ---- lane threads: the device half of the pipeline -------------------

    def _settle(self, lane: _Lane, results) -> None:
        """Make ``results`` (a tree of tensors made on ``lane``'s streams)
        safe to hand to any thread and stream: wait for the lane's
        streams, then tie each tensor's memory to the reader streams (see
        the module docstring). Nothing to do on the CPU."""
        if not lane.streams:
            return
        for s in lane.streams:
            s.synchronize()
        for leaf in tree_leaves(results):
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                for s in self._readers:
                    if s.device == leaf.device:
                        leaf.record_stream(s)

    def _lane_loop(self, lane: _Lane) -> None:
        while True:
            item = lane.work.get()
            if item is _SENTINEL:
                return
            tag, kind, reqs, extra = item
            with lane.on_streams():
                try:
                    if tag == "refill":
                        # extra = bucket shape; reqs GROWS in place as the
                        # session admits, so the fallback below covers
                        # every request the session ever owned
                        self._solve_refill(lane, kind, reqs, extra)
                    elif tag == "warm":
                        self._solve_warm_batch(lane, kind, reqs)
                    else:
                        self._solve_batch(lane, kind, reqs, extra)
                except Exception:
                    try:
                        self._isolate_failures(lane, kind, reqs)
                    except Exception as e:
                        # last resort: the lane thread must survive and
                        # every future must resolve, or shutdown could
                        # hang
                        for r in reqs:
                            if not r.future.done():
                                self.metrics.record_done(0.0, ok=False)
                                r.future.set_exception(e)

    def _solve_batch(self, lane: _Lane, kind: str, reqs: list[_Request],
                     preps: list) -> None:
        results: dict[int, Any] = {}
        for prep in preps:
            compact = choose_driver(
                self.metrics.convergence.spread(kind),
                len(prep.idxs), threshold=self.spread_threshold,
                min_batch=self.min_compact_batch, forced=self.dispatch)
            t_disp = time.monotonic()
            with trace_cycles(self.metrics.record_live_trace):
                out, stats = lane.engine.solve_prepared(
                    prep, compact=compact)
            if self.tracer is not None:
                # per-ticket view of the bucket dispatch (the engine also
                # records the aggregate device-solve span)
                t_end = time.monotonic()
                for i in prep.idxs:
                    self.tracer.record(
                        "solve", t_disp, t_end, ticket=reqs[i].ticket,
                        kind=kind, bucket=list(prep.shape),
                        driver="compacted" if compact else "masked",
                        init="cold")
            self.metrics.record_dispatch(
                kind, compact=compact, spread=stats.spread,
                occupancy=stats.n_real / self.max_batch,
                rounds=stats.rounds_mean, heuristics=stats.heur_mean)
            results.update(out)
        self._settle(lane, results)
        # cold solves count into the warm-fraction denominator too
        self.metrics.record_warm(kind, 0, len(reqs))
        now = time.monotonic()
        for i, r in enumerate(reqs):
            self._cache_result(kind, r, results[i])
            # metrics BEFORE resolution: a caller waiting on result() may
            # read snapshot() the instant the future resolves
            self.metrics.record_done((now - r.submit_t) * 1e3)
            if self.tracer is None:
                r.future.set_result(results[i])
            else:
                tr0 = time.monotonic()
                r.future.set_result(results[i])
                self.tracer.record("resolve", tr0, time.monotonic(),
                                   ticket=r.ticket, kind=kind)

    def _solve_warm_batch(self, lane: _Lane, kind: str,
                          reqs: list[_Request]) -> None:
        """One warm-seeded (possibly mixed warm/cold) closed batch.

        Routes through ``SolverEngine.solve_requests(warm=)`` — the
        per-instance warm/cold init seam — instead of the two-stage
        prepare/solve pipeline. Warm instances' rounds are kept OUT of the
        kind's cold-rounds EWMA (they would drag the baseline down and
        corrupt the rounds-saved signal); the dispatch is recorded with
        ``rounds=None`` and the warm composition goes through
        ``record_warm`` instead.
        """
        warm = {i: r.warm for i, r in enumerate(reqs) if r.warm is not None}
        compact = choose_driver(
            self.metrics.convergence.spread(kind), len(reqs),
            threshold=self.spread_threshold,
            min_batch=self.min_compact_batch, forced=self.dispatch)
        stats_out: list = []
        t_disp = time.monotonic()
        results = lane.engine.solve_requests(
            kind, [r.payload for r in reqs], compact=compact,
            stats_out=stats_out, warm=warm)
        self._settle(lane, results)
        t_end = time.monotonic()
        for stats in stats_out:
            self.metrics.record_dispatch(
                kind, compact=stats.compact, spread=stats.spread,
                occupancy=stats.n_real / self.max_batch, rounds=None)
        cold_ewma = self.metrics.convergence.rounds(kind)
        warm_rounds = [float(results[i].rounds) for i in warm
                       if results[i] is not None
                       and getattr(results[i], "rounds", None) is not None]
        rounds_saved = (cold_ewma - sum(warm_rounds) / len(warm_rounds)
                        if cold_ewma is not None and warm_rounds else None)
        self.metrics.record_warm(kind, len(warm), len(reqs) - len(warm),
                                 rounds_saved)
        now = time.monotonic()
        for i, r in enumerate(reqs):
            self._cache_result(kind, r, results[i])
            self.metrics.record_done((now - r.submit_t) * 1e3)
            if self.tracer is None:
                r.future.set_result(results[i])
            else:
                self.tracer.record(
                    "solve", t_disp, t_end, ticket=r.ticket, kind=kind,
                    driver="compacted" if compact else "masked",
                    init="warm" if i in warm else "cold")
                tr0 = time.monotonic()
                r.future.set_result(results[i])
                self.tracer.record("resolve", tr0, time.monotonic(),
                                   ticket=r.ticket, kind=kind)

    def _refill_rt(self, kind: str):
        """The kind's refill runtime, or ``None`` if it serves closed-batch
        only (cached per kind — runtimes are stateless)."""
        if kind not in self._refill_rts:
            try:
                self._refill_rts[kind] = refill_runtime(
                    kind, **self._lanes[0].engine.kind_kw(kind))
            except ValueError:
                self._refill_rts[kind] = None
        return self._refill_rts[kind]

    def _pop_refill(self, kind: str, solver, n: int) -> list[_Request]:
        """Pop up to ``n`` pending requests of ``kind`` that fit ``solver``'s
        session bucket, preserving FIFO order of the rest."""
        with self._cond:
            q = self._pending.get(kind)
            if not q:
                return []
            taken: list[_Request] = []
            keep: list[_Request] = []
            for r in q:
                if len(taken) < n and solver.fits(r.payload):
                    taken.append(r)
                else:
                    keep.append(r)
            if taken:
                q.clear()
                q.extend(keep)
            return taken

    def _solve_refill(self, lane: _Lane, kind: str, reqs: list[_Request],
                      bshape: tuple) -> None:
        """One continuous-batching session on ``lane`` (``refill=True``).

        ``reqs`` seed the session; at every cycle boundary the session's
        ``admit`` callback pops fitting pending requests of the same kind
        (appending them to ``reqs`` — the list index IS the session request
        index), and each future resolves through ``on_result`` the moment
        its instance converges.  Capacity is ``max_batch`` rounded up to a
        multiple of the lane's shard count so the slot array splits evenly
        across its sub-mesh.  If the session itself aborts, the lane loop's
        poison-isolation fallback re-solves every unresolved request solo.
        """
        mesh = lane.engine.mesh
        sc = 1 if mesh is None else shard_count(mesh, lane.engine.mesh_axis)
        cap = -(-self.max_batch // sc) * sc
        solver = lane.engine.refill_session(kind, shape=bshape, capacity=cap)
        self.metrics.record_refill_session(kind)
        # per-request solve-span starts: seeds start with the session, an
        # admitted request the moment its admission lands
        t_session = time.monotonic()
        solve_t0 = {i: t_session for i in range(len(reqs))}

        def admit_cb(n_free: int) -> list:
            t_adm = time.monotonic()
            taken = self._pop_refill(kind, solver, n_free)
            live = [r for r in taken
                    if r.future.set_running_or_notify_cancel()]
            self.metrics.record_cancelled(len(taken) - len(live))
            if live:
                self.metrics.record_refill_admit(kind, len(live))
                base = len(reqs)
                reqs.extend(live)
                if self.tracer is not None:
                    t_end = time.monotonic()
                    for j, r in enumerate(live):
                        solve_t0[base + j] = t_end
                        self.tracer.record("queue-wait", r.queued_t, t_adm,
                                           ticket=r.ticket, kind=kind,
                                           trigger="refill")
                    self.tracer.record(
                        "refill-admission", t_adm, t_end, kind=kind,
                        n_free=n_free, admitted=len(live),
                        tickets=[r.ticket for r in live])
                else:
                    for j in range(len(live)):
                        solve_t0[base + j] = t_adm
            return [r.payload if r.warm is None else (r.payload, r.warm)
                    for r in live]

        def on_result(idx: int, res) -> None:
            r = reqs[idx]
            self._settle(lane, res)
            self._cache_result(kind, r, res)
            now = time.monotonic()
            self.metrics.record_done((now - r.submit_t) * 1e3)
            if self.tracer is None:
                r.future.set_result(res)
            else:
                self.tracer.record("solve", solve_t0.get(idx, t_session),
                                   now, ticket=r.ticket, kind=kind,
                                   bucket=list(bshape), driver="refill",
                                   init="warm" if r.warm is not None
                                   else "cold")
                tr0 = time.monotonic()
                r.future.set_result(res)
                self.tracer.record("resolve", tr0, time.monotonic(),
                                   ticket=r.ticket, kind=kind)

        def on_error(idx: int, e: Exception) -> None:
            r = reqs[idx]
            self.metrics.record_done(0.0, ok=False)
            r.future.set_exception(e)

        def trace(cycle: int, n_live: int) -> None:
            self.metrics.record_live_trace(cycle, n_live)
            self.metrics.record_refill_cycle(kind, n_live / cap)

        seeds = [r.payload for r in list(reqs)]
        warm_seed = {i: r.warm for i, r in enumerate(reqs)
                     if r.warm is not None}
        with trace_cycles(trace):
            solver.run(seeds, admit=admit_cb, on_result=on_result,
                       on_error=on_error, warm=warm_seed or None)
        n_warm = sum(1 for r in reqs if r.warm is not None)
        if reqs:
            self.metrics.record_warm(kind, n_warm, len(reqs) - n_warm)

    def _isolate_failures(self, lane: _Lane, kind: str,
                          reqs: list[_Request]) -> None:
        """Batched dispatch failed: re-solve one request at a time.

        A poisoned request must fail ONLY its own future — everything else
        in its batch still gets a result (solved solo through the same
        tested path, so values are unchanged; only dispatch granularity
        differs).
        """
        for r in reqs:
            if r.future.done():          # already resolved before the raise
                continue
            t0 = time.monotonic()
            try:
                [res] = lane.engine.solve_requests(
                    kind, [r.payload],
                    warm={0: r.warm} if r.warm is not None else None)
            except Exception as e:
                self.metrics.record_done(0.0, ok=False)
                r.future.set_exception(e)
            else:
                self._settle(lane, res)
                self._cache_result(kind, r, res)
                self.metrics.record_warm(
                    kind, int(r.warm is not None), int(r.warm is None))
                now = time.monotonic()
                self.metrics.record_done((now - r.submit_t) * 1e3)
                if self.tracer is None:
                    r.future.set_result(res)
                else:
                    self.tracer.record("solve", t0, now, ticket=r.ticket,
                                       kind=kind, driver="isolated")
                    tr0 = time.monotonic()
                    r.future.set_result(res)
                    self.tracer.record("resolve", tr0, time.monotonic(),
                                       ticket=r.ticket, kind=kind)

    # ---- shutdown --------------------------------------------------------

    def close(self, *, drain: bool = True) -> None:
        """Stop the scheduler. Idempotent; never hangs.

        ``drain=True`` solves everything still queued (futures resolve
        normally) before threads are joined. ``drain=False`` cancels
        queued requests' futures (``Future.cancelled()`` becomes True);
        batches already handed to a lane still complete.
        """
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._closing = True            # submit() now refuses
            if not drain:
                dropped = [r for q in self._pending.values() for r in q]
                for q in self._pending.values():
                    q.clear()
            self._cond.notify_all()
        if not drain:
            for r in dropped:
                if r.future.cancel():
                    self.metrics.record_cancelled()
        self._scheduler.join()
        for lane in self._lanes:
            lane.work.put(_SENTINEL)
        for lane in self._lanes:
            lane.thread.join()

    def __enter__(self) -> "AsyncSolverEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)
