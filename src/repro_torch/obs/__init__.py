"""repro_torch.obs: tracing and telemetry for the port's solver serving.

Counterpart of ``repro/obs/__init__.py``, with the same ``__all__``:

* SPANS: ``Tracer`` records per-request lifecycle spans
  (submit/queue-wait/bucket-pad/device-solve/refill-admission/resolve)
  through the instrumented engines; export with ``Tracer.save`` (Chrome
  trace, Perfetto-loadable) or read ``Tracer.spans()`` directly. Install
  ambiently with ``use_tracer`` (engines capture it at construction) or
  pass ``tracer=`` explicitly.
* CYCLE EVENTS: ``repro_torch.core.solver_loop.cycle_events`` streams
  structured per-cycle telemetry (live counts, rounds, heuristic
  invocations, compaction gathers) from both solver-loop drivers.
* METRICS EXPORT: ``prometheus_text`` renders a ``SchedulerMetrics``
  snapshot in the Prometheus text exposition format;
  ``step_annotation`` lines device timelines up with host spans under
  ``torch.profiler``.

Disabled observability is free by construction: every hook is a single
``None``/contextvar check, and results are bit-identical with tracing on
or off (tests/test_torch_obs.py).
"""
from repro_torch.obs.export import prometheus_text
from repro_torch.obs.trace import (Span, Tracer, current_tracer, load_trace,
                                   step_annotation, use_tracer)

__all__ = [
    "Span",
    "Tracer",
    "current_tracer",
    "load_trace",
    "prometheus_text",
    "step_annotation",
    "use_tracer",
]
