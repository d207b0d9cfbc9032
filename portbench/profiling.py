"""A traced segment of a run: the device's work and idle time from
``torch.profiler``.

The segment opens the profiler, launches ``PRIMER_OPS`` small device ops
and waits for them (the profiler has lost a trace's first device events
before), then runs the traced work under one ``SEGMENT`` range. Only
events inside that range count. The reduction reads the profiler's raw
event list, not ``key_averages``, which is slow on a trace of some
hundred thousand events.
"""
from __future__ import annotations

import bisect
import contextlib
import re
from typing import Callable, NamedTuple

import torch

PRIMER_OPS = 2000
SEGMENT = "portbench.segment"
TOP = 10          # entries of each breakdown list


class Summary(NamedTuple):
    window_s: float                  # the segment's length
    busy_s: float                    # union of device events in it
    n_ops: int                       # device events (kernels, copies, sets)
    by_name: dict                    # name -> [count, seconds]
    idle_by_host: list               # [[host activity, seconds]], longest first

    def kernel(self, trace_name: str) -> tuple[int, float]:
        """Launches and device seconds of the kernel whose trace name
        contains ``trace_name`` as a whole word."""
        pat = re.compile(rf"\b{re.escape(trace_name)}\b")
        n, s = 0, 0.0
        for name, (c, t) in self.by_name.items():
            if pat.search(name):
                n, s = n + c, s + t
        return n, s

    def top_ops(self) -> list:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
        return [[_short(k), v[1]] for k, v in ops]


def _short(name: str) -> str:
    """A kernel's name without its trailing argument list."""
    if name.endswith(")") and "(" in name:
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.strip()[:200]


def span(name: str, on: bool):
    """A profiler range named ``name`` when ``on``, else nothing."""
    return torch.profiler.record_function(name) if on else \
        contextlib.nullcontext()


def traced(fn: Callable, device: torch.device):
    """Run ``fn()`` under the profiler; returns ``(fn's result,
    Summary)``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        x = torch.zeros(1, device=device)
        for _ in range(PRIMER_OPS):
            x.add_(1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        with torch.profiler.record_function(SEGMENT):
            out = fn()
    return out, reduce(prof.profiler.kineto_results.events())


def reduce(events) -> Summary:
    """The segment's device time, op counts by name and idle gaps from a
    profiler's raw events."""
    seg = thread = None
    host = []                    # (start, end, name, is_annotation, thread)
    dev = []                     # (start, end, name)
    for e in events:
        kind = str(e.device_type())
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if kind.endswith("CPU"):
            name = e.name()
            if name == SEGMENT:
                seg, thread = (start, end), e.start_thread_id()
            elif not name.startswith("cu"):       # not a CUDA runtime call
                host.append((start, end, name, bool(e.is_user_annotation()),
                             e.start_thread_id()))
        elif kind.endswith("CUDA") and not e.is_user_annotation():
            dev.append((start, end, e.name() or "(unnamed)"))
    if seg is None:
        raise RuntimeError(f"the trace holds no {SEGMENT!r} range")
    host = [h[:4] for h in host if h[4] == thread]
    lo, hi = seg
    dev = sorted(d for d in dev if d[0] >= lo and d[1] <= hi)
    by_name: dict = {}
    for s, t, name in dev:
        c = by_name.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += (t - s) * 1e-9
    busy, gaps = 0, []
    cur_s = cur_t = None
    for s, t, _ in dev:
        if cur_t is None:
            gaps.append((lo, s))
            cur_s, cur_t = s, t
        elif s > cur_t:
            busy += cur_t - cur_s
            gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy += cur_t - cur_s
        gaps.append((cur_t, hi))
    return Summary(window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9,
                   n_ops=len(dev), by_name=by_name,
                   idle_by_host=_label_gaps(gaps, host))


def _label_gaps(gaps, host) -> list:
    """Idle time summed by what the host was doing in the middle of each
    gap: the innermost benchmark range and the innermost host op there."""
    host.sort(key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    totals: dict = {}
    stack: list = []
    ptr = 0
    for g0, g1 in sorted(gaps):
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        end = bisect.bisect_right(starts, mid)
        while ptr < end:
            h = host[ptr]
            while stack and stack[-1][1] < h[0]:
                stack.pop()
            stack.append(h)
            ptr += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        inner = [h for h in stack if h[0] <= mid <= h[1]]
        ranges = [h[2] for h in inner if h[3]]
        ops = [h[2] for h in inner if not h[3]]
        label = "/".join(x for x in (ranges[-1] if ranges else "",
                                     ops[-1] if ops else "python") if x)
        totals[label] = totals.get(label, 0.0) + (g1 - g0) * 1e-9
    return [[k, v] for k, v in sorted(totals.items(),
                                      key=lambda kv: -kv[1])[:TOP]]
