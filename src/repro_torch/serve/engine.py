"""Serving: batched model prefill and greedy decode, and the batched-solver
request path.

Counterpart of ``repro/serve/engine.py``. The LLM half:
``make_prefill_step`` runs the prompt through the model (K6 attention on
the card) and fills the KV caches, ``make_serve_step`` decodes one new
token for every request against them, ``greedy_generate`` loops the two.
The solver half, ``SolverEngine``, queues requests of mixed kinds and
ragged shapes with ``submit(kind, payload)`` and solves them together on
``flush()`` through each registered kind's host stage (pad and bucket,
numpy) and device stage (one batched solve per bucket, on the card unless
``device="cpu"``); it is also the synchronous core the async scheduler
(``repro_torch.serve.scheduler.AsyncSolverEngine``) drives.

The JAX steps take the params tree as an argument; here the parameters
live in the ``Model``, so the step makers take the model. Steps run under
``torch.inference_mode`` and update the caches in place (see
``models/attention.py``). On a mesh (``models.model.shard_model``) the
steps take this rank's rows of the batch and caches (``init_caches(...,
shd=model.shd)``) and every rank of ``model`` picks the same tokens from
the logits made whole over the vocabulary. A server places its model
with ``shard_model(..., fsdp=False)``, weights whole over ``data``, so no
step gathers them; on the reference's placement every step does.
"""
from __future__ import annotations

import time
import warnings
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import resolve_device
# validators live in repro_torch.core.batch (each kind registers its
# own); re-exported here, where the reference keeps them too
from repro_torch.core.batch import (BucketStats, PreparedBucket,  # noqa: F401
                                    validate_assignment_matrix,
                                    validate_grid_problem)
from repro_torch.core.kinds import get_kind
from repro_torch.models.model import (Model, apply_model, init_caches,
                                      whole_logits)
from repro_torch.obs.trace import current_tracer, step_annotation


class ServeState(NamedTuple):
    caches: Any
    last_tokens: torch.Tensor   # (B,) int32, most recent token per request
    lengths: torch.Tensor       # (B,) int32, current sequence lengths
    # (B, vocab) logits that chose last_tokens; the port keeps them so a
    # caller can check a step against a reference (the JAX state has none)
    logits: Optional[torch.Tensor] = None


def _greedy(logits):
    """First maximum per row, as ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_prefill_step(model: Model):
    @torch.inference_mode()
    def prefill(tokens, caches):
        """tokens: (B, S). Returns (first generated token, ServeState)."""
        out = apply_model(model, {"tokens": tokens}, caches=caches,
                          logits_mode="last")
        last = whole_logits(model, out.logits[:, -1])
        nxt = _greedy(last)
        B, S = tokens.shape
        return nxt, ServeState(out.caches, nxt,
                               torch.full((B,), S, dtype=torch.int32,
                                          device=tokens.device), last)
    return prefill


def make_serve_step(model: Model):
    """Decode one token for the whole batch.

    The position comes from ``state.lengths[0]`` on the device (no host
    sync), so one step serves every decode position.
    """
    @torch.inference_mode()
    def serve_step(state: ServeState):
        out = apply_model(model, {"tokens": state.last_tokens[:, None]},
                          caches=state.caches, decode=True,
                          pos_offset=state.lengths[0], logits_mode="last")
        last = whole_logits(model, out.logits[:, -1])
        nxt = _greedy(last)
        return nxt, ServeState(out.caches, nxt, state.lengths + 1, last)
    return serve_step


@torch.inference_mode()
def greedy_generate(model: Model, prompt_tokens, max_new: int):
    """Reference end-to-end generation loop: ``(B, max_new)`` int32 tokens
    on the prompts' device (on a mesh: this rank's rows of the prompts)."""
    B, S = prompt_tokens.shape
    if model.shd.mesh is not None:      # the whole batch's caches
        B *= model.shd.data_groups
    caches = init_caches(model.cfg, B, S + max_new + 1, dtype=torch.float32,
                         device=prompt_tokens.device, shd=model.shd)
    nxt, state = make_prefill_step(model)(prompt_tokens, caches)
    step = make_serve_step(model)
    toks = [nxt]
    for _ in range(max_new - 1):
        nxt, state = step(state)
        toks.append(nxt)
    return torch.stack(toks, dim=1)


# ---------------------------------------------------------------- solvers


def _merge_deprecated_kw(solver_kw: dict | None, maxflow_kw: dict | None,
                         assignment_kw: dict | None,
                         owner: str) -> dict[str, dict]:
    """Fold the legacy per-kind kwargs into ``solver_kw`` (with warnings)."""
    merged = {k: dict(v) for k, v in (solver_kw or {}).items()}
    for kind, kw, name in (("maxflow", maxflow_kw, "maxflow_kw"),
                           ("assignment", assignment_kw, "assignment_kw")):
        if kw is not None:
            warnings.warn(
                f"{owner}({name}=...) is deprecated; use "
                f"solver_kw={{{kind!r}: {{...}}}}",
                DeprecationWarning, stacklevel=3)
            merged.setdefault(kind, {}).update(kw)
    return merged


def _check_no_device(solver_kw: dict[str, dict], owner: str) -> None:
    """The engines own the device: a per-kind one would split a batch's
    kinds across devices and the lanes' streams from their work."""
    named = sorted(k for k, kw in solver_kw.items() if "device" in kw)
    if named:
        raise ValueError(
            f"{owner}: solver_kw of {named} names a device; pass "
            f"device= to the engine, which forwards it to every kind")


class SolverEngine:
    """Request queue -> pad-and-bucket -> batched solve, on one device.

    The serving front door for every registered solver kind. Callers
    ``submit(kind, payload)`` problems as they arrive and receive integer
    tickets; ``flush()`` solves everything pending (each kind through its
    registered host and device stages, ``repro_torch.core.kinds``) and
    returns ``{ticket: result}``. Results are exactly what the direct
    front-end call (``repro_torch.core.batch.solve_batch``) returns: same
    padding, same bucketing, the same bits.

    Partial-failure contract: ``flush`` solves one kind at a time and
    DELIVERS each kind the moment it completes (into an internal ready
    buffer). If a later kind's batch raises, the exception propagates, but
    the completed kinds' results are NOT discarded: the next successful
    ``flush`` returns them without solving them again, and only the
    failing kind's queue stays populated for retry.

    Args:
      device: where every kind solves (``repro_torch.resolve_device``:
        the card unless ``"cpu"``); forwarded to each kind's solver with
        its ``solver_kw``, which may therefore name no device.
      mesh / mesh_axis: optional lane set
        (``repro_torch.launch.mesh.make_solver_mesh``): each bucket's
        batch splits across it, padded with inert instances.
      bucket: bucketing policy for ragged queues (``"max"`` | ``"pow2"`` |
        ``"exact"``).
      compact: early-exit compaction of each bucket's batch (the
        ``compact=`` knob of ``repro_torch.core.batch``); off by default.
        Results stay bit-identical.
      solver_kw: per-kind solver keyword overrides, keyed by kind name:
        ``{"maxflow": {"backend": ...}, "matching": {"max_rounds": ...}}``.
      maxflow_kw / assignment_kw: DEPRECATED: the pre-registry spelling of
        ``solver_kw`` for the two original kinds; folded into
        ``solver_kw`` with a ``DeprecationWarning``.
      tracer: optional ``repro_torch.obs.Tracer`` recording lifecycle
        spans (``submit`` / ``bucket/pad`` / ``device-solve``) through
        this engine. Defaults to the AMBIENT tracer at construction
        (``repro_torch.obs.use_tracer``, captured once, because
        contextvars do not cross the threads a scheduler may drive this
        engine from); ``None`` records nothing and costs one ``None``
        check per stage.
      cache: optional ``repro_torch.core.warm.SolutionCache`` backing the
        incremental re-solve path (``submit(..., base=, delta=)``).
        Defaults to a private per-engine cache. Every solved request of a
        kind with a registered ``solution_of`` hook is cached, so any
        prior ticket can seed a warm re-solve.
      metrics: optional ``repro_torch.serve.metrics.SchedulerMetrics``:
        the engine records cache lookups and warm/cold solve composition
        into it (the async scheduler threads its own through here).
    """

    def __init__(self, *, device=None, mesh=None,
                 mesh_axis: str | None = None, bucket: str = "max",
                 compact: bool = False,
                 solver_kw: dict[str, dict] | None = None,
                 maxflow_kw: dict | None = None,
                 assignment_kw: dict | None = None,
                 tracer=None, cache=None, metrics=None):
        from repro_torch.core.warm import SolutionCache
        self.device = resolve_device(device)
        self.mesh, self.mesh_axis, self.bucket = mesh, mesh_axis, bucket
        self.compact = compact
        self.tracer = tracer if tracer is not None else current_tracer()
        self.cache = cache if cache is not None else SolutionCache()
        self.metrics = metrics
        self.solver_kw = _merge_deprecated_kw(
            solver_kw, maxflow_kw, assignment_kw, "SolverEngine")
        _check_no_device(self.solver_kw, "SolverEngine")
        self._next_ticket = 0
        # per-kind queues, keyed lazily on first submit; dict insertion
        # order fixes the kind order of flush (and so of the
        # partial-failure delivery contract)
        self._queues: dict[str, list[tuple[int, Any]]] = {}
        # results of kinds that completed before a later kind's flush raised
        self._ready: dict[int, Any] = {}
        # ticket -> (kind, cache key) for every solved request whose kind
        # registered a solution_of hook: lets submit(base=ticket) resolve
        self._key_of_ticket: dict[int, tuple[str, str]] = {}
        # ticket -> WarmStart for queued warm requests
        self._warm_of_ticket: dict[int, Any] = {}

    def kind_kw(self, kind: str) -> dict:
        """The solver knobs ``kind`` solves with: its ``solver_kw`` and
        this engine's device."""
        return {**self.solver_kw.get(kind, {}), "device": self.device}

    def _ticket(self) -> int:
        t, self._next_ticket = self._next_ticket, self._next_ticket + 1
        return t

    def _resolve_base(self, kind: str, base):
        """``submit(base=)`` -> ``(base_problem, solution)`` or raise.

        ``base`` is a prior ticket of this engine (int) or a
        ``SolutionCache`` content key (str). Records the lookup hit/miss;
        a miss raises ``KeyError``: warm submission demands its seed, and
        the caller falls back to a plain cold ``submit`` explicitly.
        """
        if isinstance(base, int):
            mapped = self._key_of_ticket.get(base)
            if mapped is None or mapped[0] != kind:
                if self.metrics is not None:
                    self.metrics.record_cache_lookup(False)
                raise KeyError(
                    f"base ticket {base} has no cached {kind!r} solution "
                    f"(unsolved, evicted, or a different kind)")
            base = mapped[1]
        hit = self.cache.get(base)
        if self.metrics is not None:
            self.metrics.record_cache_lookup(hit is not None)
        if hit is None:
            raise KeyError(
                f"no cached solution under key {base!r} (evicted?)")
        return hit.problem, hit.solution

    def submit(self, kind: str, payload=None, *, base=None, delta=None) -> int:
        """Queue one request of a registered kind; returns its ticket.

        Malformed payloads are rejected HERE, by the kind's registered
        validator, BEFORE a ticket is issued, so ``flush`` cannot be
        wedged by a bad queue entry. Unknown kinds raise ``ValueError``
        naming the registered ones.

        Incremental re-solve: pass ``base=`` (a prior ticket of this
        engine or a ``SolutionCache`` key) to warm-start from that solved
        instance. ``delta`` (a ``GraphDelta`` or sequence) then derives
        the new payload from the base problem when ``payload`` is
        ``None``; an explicit ``payload`` with ``base=`` warm-starts that
        payload directly. A ``base`` with no cached solution raises
        ``KeyError`` (the caller retries cold).
        """
        t0 = time.monotonic() if self.tracer is not None else 0.0
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
        t = self._ticket()
        self._queues.setdefault(kind, []).append((t, payload))
        if ws is not None:
            self._warm_of_ticket[t] = ws
        if self.tracer is not None:
            self.tracer.record("submit", t0, time.monotonic(),
                               ticket=t, kind=kind,
                               init="warm" if ws is not None else "cold")
        return t

    def submit_maxflow(self, problem) -> int:
        """DEPRECATED: use ``submit("maxflow", problem)``."""
        warnings.warn(
            'submit_maxflow(...) is deprecated; use submit("maxflow", ...)',
            DeprecationWarning, stacklevel=2)
        return self.submit("maxflow", problem)

    def submit_assignment(self, w) -> int:
        """DEPRECATED: use ``submit("assignment", w)``."""
        warnings.warn(
            'submit_assignment(...) is deprecated; use '
            'submit("assignment", ...)', DeprecationWarning, stacklevel=2)
        return self.submit("assignment", w)

    def pending(self) -> int:
        """Number of queued, unsolved requests."""
        return sum(len(q) for q in self._queues.values())

    # ---- the synchronous core the async scheduler drives ----------------

    def prepare(self, kind: str, payloads: list) -> list[PreparedBucket]:
        """HOST stage: pad-and-bucket ``payloads`` of one kind.

        Pure host work (numpy; the kind's registered ``prepare_buckets``
        with this engine's bucket and lane configuration): the stage the
        async scheduler overlaps with the previous batch's device solve.
        """
        if self.tracer is None:
            return get_kind(kind).prepare_buckets(
                payloads, bucket=self.bucket, mesh=self.mesh,
                mesh_axis=self.mesh_axis)
        with self.tracer.span("bucket/pad", kind=kind, n=len(payloads)):
            return get_kind(kind).prepare_buckets(
                payloads, bucket=self.bucket, mesh=self.mesh,
                mesh_axis=self.mesh_axis)

    def solve_prepared(self, prep: PreparedBucket, *,
                       compact: bool | None = None) \
            -> tuple[dict[int, Any], BucketStats]:
        """DEVICE stage: dispatch one prepared bucket.

        The stacked problem goes to this engine's device on the calling
        thread's current stream. ``compact=None`` uses the engine default;
        the async scheduler overrides it per dispatch (adaptive masked vs
        compacted choice). Returns ``({payload_position: result},
        BucketStats)``.
        """
        compact = self.compact if compact is None else compact
        if self.tracer is None:
            return get_kind(prep.kind).solve_prepared(
                prep, compact=compact, mesh=self.mesh,
                mesh_axis=self.mesh_axis, **self.kind_kw(prep.kind))
        driver = "compacted" if compact else "masked"
        with self.tracer.span("device-solve", kind=prep.kind,
                              bucket=list(prep.shape),
                              n_real=len(prep.idxs), driver=driver,
                              init="cold"), \
                step_annotation(f"solve:{prep.kind}"):
            return get_kind(prep.kind).solve_prepared(
                prep, compact=compact, mesh=self.mesh,
                mesh_axis=self.mesh_axis, **self.kind_kw(prep.kind))

    def solve_requests(self, kind: str, payloads: list, *,
                       compact: bool | None = None,
                       stats_out: list | None = None,
                       warm: dict | None = None) -> list:
        """Solve ``payloads`` of one kind; results in input order.

        ``prepare`` + ``solve_prepared`` composed back to back: the
        blocking path ``flush`` uses, and the async scheduler's poison
        isolation (one payload at a time). A non-empty ``warm``
        (``{payload_position: WarmStart}``) routes the whole batch
        through the per-instance warm/cold seam
        (``repro_torch.core.warm.solve_warm``) instead; results stay in
        input order and reach the same optima.
        """
        if warm:
            from repro_torch.core.warm import solve_warm
            compact = self.compact if compact is None else compact
            kw = dict(bucket=self.bucket, compact=compact, mesh=self.mesh,
                      mesh_axis=self.mesh_axis, stats_out=stats_out,
                      **self.kind_kw(kind))
            if self.tracer is None:
                return solve_warm(kind, payloads, warm, **kw)
            with self.tracer.span("device-solve", kind=kind,
                                  n_real=len(payloads),
                                  n_warm=len(warm), init="warm"), \
                    step_annotation(f"solve:{kind}"):
                return solve_warm(kind, payloads, warm, **kw)
        results = [None] * len(payloads)
        for prep in self.prepare(kind, payloads):
            out, stats = self.solve_prepared(prep, compact=compact)
            if stats_out is not None:
                stats_out.append(stats)
            for i, r in out.items():
                results[i] = r
        return results

    def flush(self, *, stats_out: list | None = None) -> dict[int, Any]:
        """Solve every pending request; returns ``{ticket: result}``.

        One batched dispatch per (kind, bucket shape), kinds in
        first-submission order; a flushed kind's queue is emptied even if
        a request did not converge (check ``result.converged``). An empty
        queue returns ``{}`` without dispatching. If one kind's batch
        raises, kinds that already completed stay delivered (returned by
        the next flush, not solved again) and only the failing kind
        remains queued. Requests submitted WHILE a flush is solving are
        never dropped: they stay queued for the next flush, and the
        returned dict is ticket-ordered.
        """
        for kind in list(self._queues):
            q = self._queues[kind]
            if not q:
                continue
            tickets, payloads = zip(*q)
            warm_map = {i: self._warm_of_ticket[t]
                        for i, t in enumerate(tickets)
                        if t in self._warm_of_ticket}
            res = self.solve_requests(kind, list(payloads),
                                      stats_out=stats_out, warm=warm_map)
            self._ready.update(zip(tickets, res))
            self.record_solved(kind, tickets, payloads, res,
                               warm_idx=tuple(warm_map))
            # Drop exactly the entries this flush solved, NOT q.clear():
            # a submit that lands while solve_requests is running (from a
            # callback or another thread) appends behind the snapshot,
            # and clearing would silently discard it.
            del q[:len(tickets)]
        out, self._ready = dict(sorted(self._ready.items())), {}
        return out

    def record_solved(self, kind: str, tickets, payloads, results, *,
                      warm_idx=()) -> None:
        """Post-solve bookkeeping for one kind's batch (flush and the
        async scheduler both route through here).

        Caches every result's solution artifact (kinds with a
        ``solution_of`` hook) so any solved ticket can seed a later
        ``submit(base=ticket)``, drops the tickets' pending warm seeds,
        and records the batch's warm/cold composition, including the
        rounds-saved signal when the kind has a cold-rounds EWMA baseline
        (``SchedulerMetrics.record_warm``).
        """
        k = get_kind(kind)
        for t, p, r in zip(tickets, payloads, results):
            self._warm_of_ticket.pop(t, None)
            if r is None or k.solution_of is None:
                continue
            key = self.cache.put(kind, p, k.solution_of(r))
            self._key_of_ticket[t] = (kind, key)
        if self.metrics is None or not tickets:
            return
        n_warm = len(warm_idx)
        rounds_saved = None
        cold_ewma = self.metrics.convergence.rounds(kind)
        warm_rounds = [float(results[i].rounds) for i in warm_idx
                       if results[i] is not None
                       and getattr(results[i], "rounds", None) is not None]
        if cold_ewma is not None and warm_rounds:
            rounds_saved = cold_ewma - sum(warm_rounds) / len(warm_rounds)
        self.metrics.record_warm(kind, n_warm, len(tickets) - n_warm,
                                 rounds_saved)

    def refill_session(self, kind: str, *, shape, capacity: int,
                       **overrides):
        """A continuous-batching session of ``kind`` on this engine's
        device and lanes.

        Builds a ``repro_torch.core.refill.RefillSolver`` carrying the
        engine's mesh/mesh_axis, device and per-kind ``solver_kw`` (so
        the deprecated ``maxflow_kw`` / ``assignment_kw`` spellings flow
        into the refill path too); ``overrides`` take precedence. Raises
        ``ValueError`` for kinds without a registered refill runtime.
        """
        from repro_torch.core.refill import RefillSolver
        kw = {**self.kind_kw(kind), **overrides}
        kw.setdefault("tracer", self.tracer)
        return RefillSolver(kind, shape=shape, capacity=capacity,
                            mesh=self.mesh, mesh_axis=self.mesh_axis, **kw)
