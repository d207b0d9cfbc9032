"""Span tracing: the request-lifecycle half of ``repro_torch.obs``.

Counterpart of ``repro/obs/trace.py``. A ``Tracer`` records SPANS (named
time intervals with attributes) from any number of threads at once and
exports them as a plain event list or as Chrome-trace JSON (the format
Perfetto and ``chrome://tracing`` load directly). The serving stack emits
one span chain per ticket::

    submit -> queue-wait -> bucket/pad -> device-solve -> resolve

plus ``refill-admission`` spans at continuous-batching cycle boundaries,
every span tagged with ``ticket`` / ``kind`` / bucket-shape attributes so
a trace reconstructs each request's full lifecycle.

Design constraints:

* RECORDING takes no lock: finished spans are appended to a
  ``collections.deque`` (append is atomic under the GIL) and span nesting
  lives in per-thread stacks (``threading.local``), so submit paths, the
  scheduler thread and lane threads never contend.
* DISABLED tracing costs one ``None`` check: instrumented code guards
  every span with ``if tracer is not None`` and the ambient tracer is a
  ``contextvars.ContextVar`` (``current_tracer()``), so the untraced hot
  path reads no clock, allocates nothing and builds no dict.
* Timestamps come from ``time.monotonic()``, the clock the scheduler's
  deadlines and latency metrics use, so retroactive spans (``record``)
  built from scheduler timestamps land on one axis.

The module imports no array library at import time. The device-timeline
hook (``step_annotation``) opens a ``torch.profiler.record_function``
range only while a ``torch.profiler`` session is recording, so a traced
solve's device kernels line up with its host spans in that trace.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from typing import Any, NamedTuple


class Span(NamedTuple):
    """One finished span: a named ``[t0, t1]`` interval with attributes.

    ``tid`` is the recording thread's ident; ``parent_id`` is the span id
    of the span that was OPEN on that thread when this one was recorded
    (``None`` at top level): nesting is per thread, matching how the
    scheduler's threads each own a stage of a request's lifecycle.
    """

    name: str
    t0: float                  # time.monotonic() seconds
    t1: float
    tid: int
    attrs: dict
    span_id: int
    parent_id: int | None


class Tracer:
    """Thread-safe span recorder; export via ``spans()`` / ``to_chrome()``.

    Use ``span(name, **attrs)`` as a context manager for spans that open
    and close on one thread (nesting is tracked automatically), and
    ``record(name, t0, t1, **attrs)`` for RETROACTIVE spans whose
    endpoints were measured elsewhere: queue-wait, for one, starts at the
    submit timestamp taken on the caller's thread and ends at the
    scheduler thread's pop. ``instant(name, **attrs)`` records a
    zero-length mark.
    """

    def __init__(self):
        self._events: collections.deque[Span] = collections.deque()
        self._ids = itertools.count(1)
        self._local = threading.local()

    # ---- recording (lock-free) ------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Record a span around the ``with`` body (per-thread nesting)."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        sid = next(self._ids)
        stack.append(sid)
        t0 = time.monotonic()
        try:
            yield
        finally:
            t1 = time.monotonic()
            stack.pop()
            self._events.append(Span(name, t0, t1, threading.get_ident(),
                                     attrs, sid, parent))

    def record(self, name: str, t0: float, t1: float, **attrs) -> int:
        """Record a retroactive span from externally measured endpoints.

        The parent is whatever span is open on the CALLING thread (usually
        none: cross-thread stages are stitched by their shared ``ticket``
        attribute, not by parent ids). Returns the span id.
        """
        stack = self._stack()
        sid = next(self._ids)
        self._events.append(Span(name, t0, t1, threading.get_ident(), attrs,
                                 sid, stack[-1] if stack else None))
        return sid

    def instant(self, name: str, **attrs) -> int:
        """Record a zero-length mark at the current time."""
        now = time.monotonic()
        return self.record(name, now, now, **attrs)

    # ---- export ----------------------------------------------------------

    def spans(self) -> list[Span]:
        """Finished spans in completion order (a plain event list)."""
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()

    def to_chrome(self) -> dict:
        """The trace as a Chrome-trace / Perfetto JSON object.

        Every span becomes one ``"X"`` (complete) event; ``ts``/``dur``
        are microseconds on the ``time.monotonic`` axis, ``args`` carries
        the span attributes plus ``span_id``/``parent_id``.
        """
        pid = os.getpid()
        events = [{
            "name": s.name, "ph": "X", "pid": pid, "tid": s.tid,
            "ts": s.t0 * 1e6, "dur": max(s.t1 - s.t0, 0.0) * 1e6,
            "args": {**s.attrs, "span_id": s.span_id,
                     "parent_id": s.parent_id},
        } for s in self._events]
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path) -> None:
        """Write the Chrome-trace JSON to ``path`` (open it in Perfetto)."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


def load_trace(path) -> list[dict]:
    """Load a saved trace; returns its ``traceEvents`` list.

    Accepts both the object form ``Tracer.save`` writes and the bare
    event-array form of the Chrome-trace spec.
    """
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        raise ValueError(f"{path} is not a Chrome-trace file")
    return events


# ---- ambient tracer ------------------------------------------------------

_tracer_var: contextvars.ContextVar[Tracer | None] = \
    contextvars.ContextVar("repro_obs_tracer", default=None)


def current_tracer() -> Tracer | None:
    """The ambient tracer installed by ``use_tracer``, or ``None``.

    A ``ContextVar``, so it does NOT cross thread starts: long-lived
    engines capture it ONCE at construction (``tracer=`` falls back to
    this) and hand it to their worker threads explicitly.
    """
    return _tracer_var.get()


@contextlib.contextmanager
def use_tracer(tracer: Tracer | None):
    """Install ``tracer`` as the ambient tracer for the ``with`` body."""
    token = _tracer_var.set(tracer)
    try:
        yield tracer
    finally:
        _tracer_var.reset(token)


# ---- device-timeline hook ------------------------------------------------

@contextlib.contextmanager
def step_annotation(name: str, **attrs: Any):
    """Name the ``with`` body on a running ``torch.profiler`` timeline.

    While a profiler session records, the body becomes a
    ``record_function`` range called ``name`` (``attrs`` as its argument
    string), so the device kernels it launches line up with the host
    spans this module records. Without a session the cost is one flag
    read; instrumented code also gates the call on an active tracer, so
    the untraced hot path never reaches it.
    """
    import torch
    if not torch.autograd._profiler_enabled():
        yield
        return
    args = ", ".join(f"{k}={v}" for k, v in attrs.items()) or None
    with torch.profiler.record_function(name, args):
        yield
