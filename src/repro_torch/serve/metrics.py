"""Serving metrics: EWMA stats registry + the scheduler's telemetry surface.

Counterpart of ``repro/serve/metrics.py``. Two consumers share this
module:

* the ADAPTIVE DISPATCH policy of ``repro_torch.serve.scheduler``: an
  EWMA over the per-bucket convergence spread
  (``repro_torch.core.batch.BucketStats.spread``) decides masked vs
  compacted dispatch per kind, and
* OPERATORS: ``SchedulerMetrics.snapshot()`` exposes queue depth, batch
  occupancy, ticket-latency percentiles (p50/p99), flush-trigger counts,
  and per-driver dispatch counts as one plain dict.

Everything here is thread-safe (one lock per registry): submit paths, the
scheduler thread, and the lane threads all record concurrently. Nothing
imports torch: metrics stay importable (and testable) without touching
device state.
"""
from __future__ import annotations

import collections
import copy
import threading
from typing import Any

import numpy as np


class Ewma:
    """Exponentially-weighted moving average; ``None`` until first update.

    ``alpha`` is the weight of the NEW observation (0.25 ~= averaging over
    the last ~4 batches) — recent convergence behaviour should dominate a
    serving stream whose difficulty drifts.
    """

    def __init__(self, alpha: float = 0.25):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self._value: float | None = None

    def update(self, x: float) -> float:
        v = self._value
        self._value = float(x) if v is None else \
            self.alpha * float(x) + (1.0 - self.alpha) * v
        return self._value

    @property
    def value(self) -> float | None:
        return self._value


class LatencyWindow:
    """Ring buffer of recent ticket latencies (ms) -> p50/p99 percentiles.

    A bounded window (default: the last 1024 tickets), not a full history:
    serving percentiles should describe CURRENT behaviour, and the buffer
    must not grow with uptime.
    """

    def __init__(self, maxlen: int = 1024):
        self._buf: collections.deque[float] = collections.deque(maxlen=maxlen)

    def record(self, latency_ms: float) -> None:
        self._buf.append(float(latency_ms))

    def __len__(self) -> int:
        return len(self._buf)

    def percentiles(self, qs=(50.0, 99.0)) -> dict[str, float | None]:
        if not self._buf:
            return {f"p{q:g}": None for q in qs}
        arr = np.asarray(self._buf)
        return {f"p{q:g}": float(np.percentile(arr, q)) for q in qs}


class ConvergenceStats:
    """Per-kind EWMA registry over observed batch convergence spread.

    The adaptive-dispatch signal: ``spread`` of a bucket is
    ``(rounds_max - rounds_min) / max(rounds_max, 1)`` over its real
    instances (``BucketStats.spread``). A stream whose spread EWMA is high
    is ragged — stragglers dominate masked dispatches and early-exit
    compaction pays; a low EWMA means the batch converges together and the
    single-dispatch masked driver wins.
    """

    def __init__(self, alpha: float = 0.25):
        self._alpha = alpha
        self._lock = threading.Lock()
        self._spread: dict[str, Ewma] = {}
        self._occupancy: dict[str, Ewma] = {}
        self._rounds: dict[str, Ewma] = {}
        self._heuristics: dict[str, Ewma] = {}

    def observe(self, kind: str, *, spread: float,
                occupancy: float | None = None,
                rounds: float | None = None,
                heuristics: float | None = None) -> None:
        with self._lock:
            self._spread.setdefault(kind, Ewma(self._alpha)).update(spread)
            if occupancy is not None:
                self._occupancy.setdefault(
                    kind, Ewma(self._alpha)).update(occupancy)
            if rounds is not None:
                self._rounds.setdefault(kind, Ewma(self._alpha)).update(rounds)
            if heuristics is not None:
                self._heuristics.setdefault(
                    kind, Ewma(self._alpha)).update(heuristics)

    def spread(self, kind: str) -> float | None:
        with self._lock:
            e = self._spread.get(kind)
            return None if e is None else e.value

    def occupancy(self, kind: str) -> float | None:
        with self._lock:
            e = self._occupancy.get(kind)
            return None if e is None else e.value

    def rounds(self, kind: str) -> float | None:
        """EWMA of per-dispatch mean solver rounds (``rounds_mean``)."""
        with self._lock:
            e = self._rounds.get(kind)
            return None if e is None else e.value

    def heuristics(self, kind: str) -> float | None:
        """EWMA of per-dispatch mean heuristic invocations (``heur_mean``)."""
        with self._lock:
            e = self._heuristics.get(kind)
            return None if e is None else e.value

    def kinds(self) -> tuple[str, ...]:
        """Every kind observed so far (union of all stat keys)."""
        with self._lock:
            return tuple(dict.fromkeys(
                [*self._spread, *self._occupancy, *self._rounds,
                 *self._heuristics]))


class SchedulerMetrics:
    """The async scheduler's full telemetry surface (thread-safe).

    Counters: submitted / completed / failed / cancelled tickets; flushes
    by trigger (``size`` | ``deadline`` | ``manual`` | ``drain``);
    dispatches by ``(kind, driver)`` where driver is ``masked`` or
    ``compacted``. Gauges: current queue depth. Distributions: ticket
    latency (submit -> future resolution) percentiles, batch-occupancy
    EWMA (real instances / max_batch), convergence-spread EWMA, per-kind
    solver-rounds and heuristic-invocation EWMAs (``rounds_ewma`` /
    ``heuristics_ewma`` — the workload-difficulty gauges fed from
    ``BucketStats.rounds_mean``/``heur_mean``), and the compacted
    driver's live-count decay (via
    ``repro_torch.core.solver_loop.trace_cycles``).

    Continuous batching (``refill`` snapshot key): sessions opened and
    requests admitted mid-solve per kind, a per-kind slot-occupancy EWMA
    sampled every refill cycle, and the steady-state batch utilization
    (mean live/capacity across all refill cycles).

    Warm starts (``warm`` snapshot key): solution-cache lookups (hits /
    misses / hit rate), warm-vs-cold solve counts and the warm fraction,
    and a per-kind EWMA of rounds saved per warm solve relative to the
    kind's cold-rounds baseline (``rounds_saved_ewma`` — fed by the
    scheduler and engines through ``record_warm``).
    """

    def __init__(self, *, latency_window: int = 1024, ewma_alpha: float = 0.25):
        self._lock = threading.Lock()
        self.convergence = ConvergenceStats(alpha=ewma_alpha)
        self._latency = LatencyWindow(maxlen=latency_window)
        self._counts = collections.Counter()
        self._flushes = collections.Counter()
        self._dispatches = collections.Counter()
        self._queue_depth = 0
        self._compact_cycles = 0
        self._compact_live_total = 0
        self._ewma_alpha = ewma_alpha
        self._refill_sessions = collections.Counter()
        self._refill_admitted = collections.Counter()
        self._refill_cycles = 0
        self._refill_occ_total = 0.0
        self._refill_occ_ewma: dict[str, Ewma] = {}
        self._cache_lookups = collections.Counter()   # "hit" / "miss"
        self._warm_solves = collections.Counter()     # "warm" / "cold"
        self._rounds_saved_ewma: dict[str, Ewma] = {}

    # ---- recording hooks (submit path / scheduler / lanes) --------------

    def record_submit(self, queue_depth: int) -> None:
        with self._lock:
            self._counts["submitted"] += 1
            self._queue_depth = queue_depth

    def record_flush(self, trigger: str, queue_depth: int) -> None:
        with self._lock:
            self._flushes[trigger] += 1
            self._queue_depth = queue_depth

    def record_dispatch(self, kind: str, *, compact: bool, spread: float,
                        occupancy: float, rounds: float | None = None,
                        heuristics: float | None = None) -> None:
        with self._lock:
            self._dispatches[(kind, "compacted" if compact else "masked")] += 1
        self.convergence.observe(kind, spread=spread, occupancy=occupancy,
                                 rounds=rounds, heuristics=heuristics)

    def record_done(self, latency_ms: float, *, ok: bool = True) -> None:
        with self._lock:
            self._counts["completed" if ok else "failed"] += 1
            if ok:
                self._latency.record(latency_ms)

    def record_cancelled(self, n: int = 1) -> None:
        with self._lock:
            self._counts["cancelled"] += n

    def record_live_trace(self, cycle: int, n_live: int) -> None:
        """Per-cycle live-count sample from the compacted driver."""
        with self._lock:
            self._compact_cycles += 1
            self._compact_live_total += n_live

    def record_refill_session(self, kind: str) -> None:
        """One continuous-batching session opened for ``kind``."""
        with self._lock:
            self._refill_sessions[kind] += 1

    def record_refill_admit(self, kind: str, n: int) -> None:
        """``n`` queued requests admitted mid-solve into a ``kind`` session."""
        with self._lock:
            self._refill_admitted[kind] += n

    def record_refill_cycle(self, kind: str, occupancy: float) -> None:
        """Per-cycle slot occupancy (live / capacity) of a refill session.

        Feeds both the steady-state utilization mean and a per-kind EWMA —
        the continuous-batching analogue of the closed-batch occupancy
        gauge, but sampled every CYCLE rather than once per dispatch, so it
        reflects how full the batch stays between admissions.
        """
        with self._lock:
            self._refill_cycles += 1
            self._refill_occ_total += float(occupancy)
            self._refill_occ_ewma.setdefault(
                kind, Ewma(self._ewma_alpha)).update(occupancy)

    def record_cache_lookup(self, hit: bool) -> None:
        """One solution-cache lookup on the warm-start path (hit or miss)."""
        with self._lock:
            self._cache_lookups["hit" if hit else "miss"] += 1

    def record_warm(self, kind: str, n_warm: int, n_cold: int,
                    rounds_saved: float | None = None) -> None:
        """Warm/cold composition of one dispatch, plus the rounds saved.

        ``rounds_saved`` is (cold-rounds EWMA of the kind) minus (this
        dispatch's mean warm rounds) — positive when warm starts converge
        in fewer rounds than the kind's recent cold baseline. Callers feed
        it only when both sides exist; the EWMA smooths per-dispatch noise.
        """
        with self._lock:
            self._warm_solves["warm"] += int(n_warm)
            self._warm_solves["cold"] += int(n_cold)
            if rounds_saved is not None:
                self._rounds_saved_ewma.setdefault(
                    kind, Ewma(self._ewma_alpha)).update(rounds_saved)

    # ---- reading --------------------------------------------------------

    def dispatch_count(self, kind: str, driver: str) -> int:
        with self._lock:
            return self._dispatches[(kind, driver)]

    def snapshot(self) -> dict[str, Any]:
        """One coherent dict of every counter/gauge/percentile.

        Returns a DEEP COPY: mutating the returned dict (any nesting
        level) can never reach live registry state, so operators may
        post-process snapshots freely (tests/test_torch_obs.py pins
        this).
        """
        with self._lock:
            snap = {
                "queue_depth": self._queue_depth,
                "tickets": dict(self._counts),
                "flushes_by_trigger": dict(self._flushes),
                "dispatches": {f"{k}:{d}": n for (k, d), n
                               in self._dispatches.items()},
                "latency_ms": self._latency.percentiles(),
                "latency_samples": len(self._latency),
                "compact_cycles": self._compact_cycles,
                "compact_live_mean": (
                    self._compact_live_total / self._compact_cycles
                    if self._compact_cycles else None),
                "refill": {
                    "sessions": dict(self._refill_sessions),
                    "admitted": dict(self._refill_admitted),
                    "slot_occupancy_ewma": {
                        k: e.value for k, e in self._refill_occ_ewma.items()},
                    "utilization": (
                        self._refill_occ_total / self._refill_cycles
                        if self._refill_cycles else None),
                },
                "warm": {
                    "cache_hits": self._cache_lookups["hit"],
                    "cache_misses": self._cache_lookups["miss"],
                    "cache_hit_rate": (
                        self._cache_lookups["hit"]
                        / sum(self._cache_lookups.values())
                        if self._cache_lookups else None),
                    "warm_solves": self._warm_solves["warm"],
                    "cold_solves": self._warm_solves["cold"],
                    "warm_fraction": (
                        self._warm_solves["warm"]
                        / sum(self._warm_solves.values())
                        if sum(self._warm_solves.values()) else None),
                    "rounds_saved_ewma": {
                        k: e.value
                        for k, e in self._rounds_saved_ewma.items()},
                },
            }
        kinds = _snapshot_kinds(self.convergence)
        snap["spread_ewma"] = {k: self.convergence.spread(k) for k in kinds}
        snap["occupancy_ewma"] = {
            k: self.convergence.occupancy(k) for k in kinds}
        snap["rounds_ewma"] = {k: self.convergence.rounds(k) for k in kinds}
        snap["heuristics_ewma"] = {
            k: self.convergence.heuristics(k) for k in kinds}
        # deepcopy is belt-and-braces over the per-field dict() copies
        # above: it guarantees the deep-isolation contract survives any
        # future field whose value nests mutable state
        return copy.deepcopy(snap)


def _snapshot_kinds(convergence: ConvergenceStats) -> tuple[str, ...]:
    """Kinds a snapshot should report EWMAs for.

    The union of the REGISTERED kinds (so a quiet kind still appears, with
    ``None`` EWMAs) and the OBSERVED kinds (so nothing recorded is ever
    hidden). The registry is peeked without importing the solver modules
    (``ensure=False``): this module must stay importable without torch.
    """
    from repro_torch.core.kinds import registered_kinds
    seen = dict.fromkeys(registered_kinds(ensure=False))
    seen.update(dict.fromkeys(convergence.kinds()))
    return tuple(seen)
