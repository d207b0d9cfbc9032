"""Prometheus-style text exposition of ``SchedulerMetrics``.

Counterpart of ``repro/obs/export.py``, line for line: the same
snapshot renders to the same text, byte for byte, as the reference.

``prometheus_text`` renders a ``SchedulerMetrics`` (or one of its
``snapshot()`` dicts) in the Prometheus text exposition format —
``# HELP`` / ``# TYPE`` headers plus one sample per value, labels for
per-kind / per-trigger / per-driver breakdowns.  Serve it from any HTTP
handler.

COMPLETENESS IS ENFORCED: every top-level snapshot key must have a
registered renderer (``_RENDERERS``), and a key without one raises — so a
future PR that adds a metric to ``SchedulerMetrics.snapshot()`` cannot
silently ship an exposition that omits it (tests/test_torch_obs.py).
``None`` values (EWMAs before their first observation, percentiles of an
empty window) keep their family header but emit no sample, which is how
Prometheus represents "no data yet".
"""
from __future__ import annotations

from typing import Any

_PREFIX = "repro"


def _escape(v: Any) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


class _Writer:
    def __init__(self):
        self.lines: list[str] = []

    def family(self, name: str, kind: str, help_: str) -> str:
        name = f"{_PREFIX}_{name}"
        self.lines.append(f"# HELP {name} {help_}")
        self.lines.append(f"# TYPE {name} {kind}")
        return name

    def sample(self, name: str, value, labels: dict | None = None) -> None:
        if value is None:
            return
        lbl = ""
        if labels:
            inner = ",".join(f'{k}="{_escape(v)}"'
                             for k, v in labels.items())
            lbl = "{" + inner + "}"
        self.lines.append(f"{name}{lbl} {float(value):g}")


def _r_queue_depth(w: _Writer, v) -> None:
    w.sample(w.family("queue_depth", "gauge",
                      "Requests queued but not yet dispatched."), v)


def _r_tickets(w: _Writer, v: dict) -> None:
    n = w.family("tickets_total", "counter",
                 "Tickets by terminal status (submitted/completed/"
                 "failed/cancelled).")
    for status, count in sorted(v.items()):
        w.sample(n, count, {"status": status})


def _r_flushes(w: _Writer, v: dict) -> None:
    n = w.family("flushes_total", "counter",
                 "Batch flushes by trigger (size/deadline/manual/drain).")
    for trigger, count in sorted(v.items()):
        w.sample(n, count, {"trigger": trigger})


def _r_dispatches(w: _Writer, v: dict) -> None:
    n = w.family("dispatches_total", "counter",
                 "Bucket dispatches by solver kind and loop driver.")
    for key, count in sorted(v.items()):
        kind, _, driver = key.partition(":")
        w.sample(n, count, {"kind": kind, "driver": driver})


def _r_latency(w: _Writer, v: dict) -> None:
    n = w.family("ticket_latency_ms", "gauge",
                 "Ticket latency percentiles (submit -> resolution) over "
                 "the recent window.")
    for key, val in sorted(v.items()):
        q = float(key.lstrip("p")) / 100.0
        w.sample(n, val, {"quantile": f"{q:g}"})


def _r_latency_samples(w: _Writer, v) -> None:
    w.sample(w.family("ticket_latency_samples", "gauge",
                      "Tickets currently in the latency window."), v)


def _r_compact_cycles(w: _Writer, v) -> None:
    w.sample(w.family("compact_cycles_total", "counter",
                      "Host cycles executed by the compacted driver."), v)


def _r_compact_live_mean(w: _Writer, v) -> None:
    w.sample(w.family("compact_live_mean", "gauge",
                      "Mean live instances per compacted cycle."), v)


def _r_refill(w: _Writer, v: dict) -> None:
    n = w.family("refill_sessions_total", "counter",
                 "Continuous-batching sessions opened, by kind.")
    for kind, count in sorted(v["sessions"].items()):
        w.sample(n, count, {"kind": kind})
    n = w.family("refill_admitted_total", "counter",
                 "Requests admitted mid-solve into refill sessions, "
                 "by kind.")
    for kind, count in sorted(v["admitted"].items()):
        w.sample(n, count, {"kind": kind})
    n = w.family("refill_slot_occupancy_ewma", "gauge",
                 "EWMA of per-cycle slot occupancy (live/capacity) of "
                 "refill sessions, by kind.")
    for kind, val in sorted(v["slot_occupancy_ewma"].items()):
        w.sample(n, val, {"kind": kind})
    w.sample(w.family("refill_utilization", "gauge",
                      "Steady-state mean live/capacity across all refill "
                      "cycles."), v["utilization"])


def _r_warm(w: _Writer, v: dict) -> None:
    n = w.family("warm_cache_lookups_total", "counter",
                 "Solution-cache lookups on the warm-start path, by "
                 "result (hit/miss).")
    w.sample(n, v["cache_hits"], {"result": "hit"})
    w.sample(n, v["cache_misses"], {"result": "miss"})
    w.sample(w.family("warm_cache_hit_rate", "gauge",
                      "Fraction of solution-cache lookups that hit."),
             v["cache_hit_rate"])
    n = w.family("warm_solves_total", "counter",
                 "Solver instances dispatched, by init mode (warm/cold).")
    w.sample(n, v["warm_solves"], {"init": "warm"})
    w.sample(n, v["cold_solves"], {"init": "cold"})
    w.sample(w.family("warm_fraction", "gauge",
                      "Fraction of dispatched instances that were "
                      "warm-started."), v["warm_fraction"])
    n = w.family("warm_rounds_saved_ewma", "gauge",
                 "EWMA of solver rounds saved per warm solve vs the "
                 "kind's cold baseline, by kind.")
    for kind, val in sorted(v["rounds_saved_ewma"].items()):
        w.sample(n, val, {"kind": kind})


def _per_kind_ewma(name: str, help_: str):
    def render(w: _Writer, v: dict) -> None:
        n = w.family(name, "gauge", help_)
        for kind, val in sorted(v.items()):
            w.sample(n, val, {"kind": kind})
    return render


_RENDERERS = {
    "queue_depth": _r_queue_depth,
    "tickets": _r_tickets,
    "flushes_by_trigger": _r_flushes,
    "dispatches": _r_dispatches,
    "latency_ms": _r_latency,
    "latency_samples": _r_latency_samples,
    "compact_cycles": _r_compact_cycles,
    "compact_live_mean": _r_compact_live_mean,
    "refill": _r_refill,
    "warm": _r_warm,
    "spread_ewma": _per_kind_ewma(
        "spread_ewma", "EWMA of per-bucket convergence spread, by kind "
        "(the adaptive-dispatch signal)."),
    "occupancy_ewma": _per_kind_ewma(
        "occupancy_ewma", "EWMA of batch occupancy (real/max_batch), "
        "by kind."),
    "rounds_ewma": _per_kind_ewma(
        "rounds_ewma", "EWMA of per-dispatch mean solver rounds, "
        "by kind."),
    "heuristics_ewma": _per_kind_ewma(
        "heuristics_ewma", "EWMA of per-dispatch mean heuristic "
        "invocations, by kind."),
}


def prometheus_text(metrics) -> str:
    """Render ``metrics`` (a ``SchedulerMetrics`` or a ``snapshot()``
    dict) in the Prometheus text exposition format.

    Raises ``KeyError`` for snapshot keys without a registered renderer —
    adding a field to the snapshot REQUIRES teaching the exposition about
    it (see module docstring).
    """
    snap = metrics.snapshot() if hasattr(metrics, "snapshot") else metrics
    w = _Writer()
    unknown = [k for k in snap if k not in _RENDERERS]
    if unknown:
        raise KeyError(
            f"snapshot keys {unknown} have no Prometheus renderer; add "
            f"them to repro_torch.obs.export._RENDERERS")
    for key, render in _RENDERERS.items():
        if key in snap:
            render(w, snap[key])
    return "\n".join(w.lines) + "\n"
