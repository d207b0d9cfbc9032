"""Observability (``repro_torch.obs``, ROADMAP M8): the port against the
JAX package.

Ported case for case from ``tests/test_obs.py`` (all but the benchmark
harness, which drives the JAX package): the ``Tracer`` (nesting, retro
spans, Chrome export, save/load, many threads, the ambient tracer,
``step_annotation``), the cycle telemetry of both solver-loop drivers,
the traced refill session, the per-ticket lifecycle of traced
``AsyncSolverEngine`` sessions (closed batch, refill, two CPU lanes,
mid-solve admission), the metrics primitives and the Prometheus
exposition. Held to the JAX package besides:

* ``prometheus_text`` of the same snapshot dict is the reference's text,
  byte for byte;
* the span STRUCTURE of a traced sync ``flush`` and of a traced refill
  session (names, attributes, span and parent ids; timestamps and thread
  ids dropped) is the reference's on the same queue;
* traced results equal untraced results, and the reference's, for every
  kind on the masked, compacted and refill paths.

Tolerance: exact equality (``assert_same``). The threaded tests wait on
events and futures, never on sleeps; ``WAIT_S`` only guards against a
hang, and no assertion reads a wall-clock duration.
"""
import json
import threading
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same

import repro.core.batch as jbatch
import repro.core.kinds as jkinds
import repro.core.refill as jrefill
import repro.obs as jobs
import repro.serve.engine as jengine
import repro.serve.metrics as jmetrics
import repro_torch.core.kinds as kinds_mod
from repro_torch.core import (cycle_events, maxflow_grid_batch,
                              match_bipartite_batch, solve_assignment,
                              trace_cycles)
from repro_torch.core.batch import solve_batch
from repro_torch.core.kinds import registered_kinds
from repro_torch.core.matching.ref import random_bipartite
from repro_torch.core.maxflow.grid import GridProblem
from repro_torch.core.maxflow.ref import random_grid_problem
from repro_torch.core.refill import RefillSolver
from repro_torch.launch.mesh import make_solver_mesh
from repro_torch.obs import (Tracer, current_tracer, load_trace,
                             prometheus_text, step_annotation, use_tracer)
from repro_torch.serve.engine import SolverEngine
from repro_torch.serve.metrics import Ewma, LatencyWindow, SchedulerMetrics
from repro_torch.serve.scheduler import AsyncSolverEngine

CPU = "cpu"
WAIT_S = 120.0
LONG_DEADLINE_MS = 600_000.0

LIFECYCLE = {"submit", "queue-wait", "solve", "resolve"}


# ------------------------------------------------------------ helpers

def _grid_problems(seed, B, H, W):
    rng = np.random.default_rng(seed)
    return [GridProblem(*random_grid_problem(rng, H, W)) for _ in range(B)]


def _grid_batch(seed, B, H, W):
    rng = np.random.default_rng(seed)
    return GridProblem(
        rng.integers(0, 5, (B, 4, H, W)).astype(np.float32),
        rng.integers(0, 6, (B, H, W)).astype(np.float32),
        rng.integers(0, 6, (B, H, W)).astype(np.float32))


def _jax(kind, payloads):
    if kind == "maxflow":
        return [jbatch.GridProblem(*map(jnp.asarray, p)) for p in payloads]
    return payloads


def _mixed_queue(seed):
    """(kind, payload) requests of every kind, interleaved, ragged."""
    rng = np.random.default_rng(seed)
    out = []
    for h, w in ((6, 6), (5, 6), (6, 6)):
        out.append(("maxflow", GridProblem(*random_grid_problem(rng, h, w))))
        out.append(("assignment", rng.integers(0, 50, (5, 5))))
        out.append(("matching", random_bipartite(rng, 6, 7, 0.3)))
    return out


def _ticket_chains(tracer: Tracer) -> dict:
    """Group lifecycle spans by their ``ticket`` attribute."""
    chains: dict = {}
    for s in tracer.spans():
        t = s.attrs.get("ticket")
        if t is not None:
            chains.setdefault(t, []).append(s)
    return chains


def _check_lifecycle(chains: dict, tickets) -> None:
    """Every ticket has a full, gap-consistent, monotonic span chain."""
    for t in tickets:
        assert t in chains, f"ticket {t} left no spans"
        by_name = {}
        for s in chains[t]:
            assert s.t0 <= s.t1, f"span {s.name} of ticket {t} runs backwards"
            by_name.setdefault(s.name, s)
        assert LIFECYCLE <= set(by_name), \
            f"ticket {t} missing stages: {LIFECYCLE - set(by_name)}"
        # submit ends where queue-wait begins; each later stage starts no
        # earlier than the previous one ended
        assert abs(by_name["submit"].t1 - by_name["queue-wait"].t0) < 1e-9
        assert by_name["queue-wait"].t1 <= by_name["solve"].t0 + 1e-9
        assert by_name["solve"].t1 <= by_name["resolve"].t0 + 1e-9


def _structure(tracer) -> list:
    """A trace without its clock and threads: (name, attrs, span id,
    parent id) per span, in completion order."""
    return [(s.name, s.attrs, s.span_id, s.parent_id)
            for s in tracer.spans()]


# ------------------------------------------------------------ tracer core

def test_span_nesting_tracks_parent_ids():
    tr = Tracer()
    with tr.span("outer", kind="maxflow"):
        with tr.span("inner", step=1):
            pass
        with tr.span("inner2"):
            pass
    with tr.span("top"):
        pass
    spans = {s.name: s for s in tr.spans()}
    assert spans["inner"].parent_id == spans["outer"].span_id
    assert spans["inner2"].parent_id == spans["outer"].span_id
    assert spans["outer"].parent_id is None
    assert spans["top"].parent_id is None
    assert spans["outer"].attrs == {"kind": "maxflow"}
    # inner spans finish (and are appended) before their parent
    assert [s.name for s in tr.spans()] == ["inner", "inner2", "outer", "top"]
    ids = [s.span_id for s in tr.spans()]
    assert len(set(ids)) == len(ids)


def test_record_and_instant_spans():
    tr = Tracer()
    sid = tr.record("queue-wait", 10.0, 12.5, ticket=7)
    tr.instant("mark", cycle=3)
    qw, mark = tr.spans()
    assert (qw.name, qw.t0, qw.t1, qw.span_id) == ("queue-wait", 10.0, 12.5,
                                                   sid)
    assert qw.attrs == {"ticket": 7}
    assert mark.t0 == mark.t1 and mark.attrs == {"cycle": 3}
    tr.clear()
    assert tr.spans() == []


def test_chrome_export_structure():
    tr = Tracer()
    with tr.span("device-solve", kind="matching", bucket=[8, 8]):
        pass
    doc = tr.to_chrome()
    assert doc["displayTimeUnit"] == "ms"
    (ev,) = doc["traceEvents"]
    assert ev["ph"] == "X" and ev["name"] == "device-solve"
    assert ev["dur"] >= 0 and isinstance(ev["ts"], float)
    assert ev["args"]["kind"] == "matching"
    assert ev["args"]["bucket"] == [8, 8]
    assert "span_id" in ev["args"] and "parent_id" in ev["args"]
    json.dumps(doc)  # must be JSON-serializable as-is
    # the reference's exporter gives the same events for the same spans
    jt = jobs.Tracer()
    for s in tr.spans():
        jt.record(s.name, s.t0, s.t1, **s.attrs)
    (jev,) = jt.to_chrome()["traceEvents"]
    assert {k: v for k, v in jev.items() if k != "tid"} == \
        {k: v for k, v in ev.items() if k != "tid"}


def test_save_load_roundtrip(tmp_path):
    tr = Tracer()
    tr.record("solve", 1.0, 2.0, ticket=0)
    path = tmp_path / "trace.json"
    tr.save(path)
    events = load_trace(path)
    assert len(events) == 1 and events[0]["name"] == "solve"
    assert jobs.load_trace(path) == events       # the reference reads it
    # the bare event-array form of the Chrome-trace spec loads too
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps(events))
    assert load_trace(bare) == events
    bad = tmp_path / "bad.json"
    bad.write_text('{"not": "a trace"}')
    with pytest.raises((ValueError, KeyError)):
        load_trace(bad)


def test_tracer_concurrent_recording():
    """Many threads record nested spans at once: nothing is lost, ids stay
    unique, and nesting never leaks across threads."""
    tr = Tracer()
    n_threads, n_spans = 8, 100
    barrier = threading.Barrier(n_threads)

    def worker(k):
        barrier.wait()
        for i in range(n_spans):
            with tr.span("outer", worker=k, i=i):
                with tr.span("inner", worker=k, i=i):
                    pass

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
        assert not t.is_alive()
    spans = tr.spans()
    assert len(spans) == n_threads * n_spans * 2
    ids = {s.span_id for s in spans}
    assert len(ids) == len(spans)
    outer_by_tid = {}
    for s in spans:
        if s.name == "outer":
            outer_by_tid.setdefault(s.tid, set()).add(s.span_id)
    for s in spans:
        if s.name == "inner":
            assert s.parent_id in outer_by_tid[s.tid], \
                "inner span parented across threads"


def test_ambient_tracer_contextvar():
    assert current_tracer() is None
    tr = Tracer()
    with use_tracer(tr) as got:
        assert got is tr and current_tracer() is tr
        with use_tracer(None):
            assert current_tracer() is None
        assert current_tracer() is tr
    assert current_tracer() is None


def test_step_annotation_is_harmless_without_profiler():
    with step_annotation("solve:maxflow", bucket="8x8"):
        x = torch.zeros((2, 2)) + 1
    assert float(x.sum()) == 4.0


def test_step_annotation_names_the_range_under_the_profiler():
    """Under ``torch.profiler`` the annotated body is a named range, so
    its device work lines up with the host spans in that trace."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with step_annotation("solve:maxflow", bucket="8x8"):
            torch.zeros((2, 2)).add_(1)
    assert "solve:maxflow" in {e.key for e in prof.key_averages()}


# ------------------------------------------------------- cycle telemetry

def test_cycle_events_masked_maxflow_bitmatch():
    prob = _grid_batch(0, 5, 6, 6)
    base = maxflow_grid_batch(prob, device=CPU)
    evs = []
    with cycle_events(evs.append, masked=True, detail=True):
        traced = maxflow_grid_batch(prob, device=CPU)
    assert evs, "masked driver emitted no cycle events"
    assert all(e.driver == "masked" for e in evs)
    assert [e.cycle for e in evs] == list(range(len(evs)))
    lives = [e.n_live for e in evs]
    assert lives == sorted(lives, reverse=True), \
        f"masked live counts not monotone: {lives}"
    assert lives[0] == 5
    assert all(e.gathered == 5 for e in evs), \
        "masked driver dispatches the full batch every cycle"
    assert all(e.heur_total is not None and e.heur_total >= 0 for e in evs)
    rt = [e.rounds_total for e in evs]
    assert rt == sorted(rt)
    assert_same(base, traced)


def test_cycle_events_compacted_maxflow_bitmatch():
    prob = _grid_batch(1, 6, 6, 6)
    base = maxflow_grid_batch(prob, compact=True, device=CPU)
    evs = []
    with cycle_events(evs.append, detail=True):
        traced = maxflow_grid_batch(prob, compact=True, device=CPU)
    assert evs and all(e.driver == "compacted" for e in evs)
    assert [e.cycle for e in evs] == list(range(len(evs)))
    lives = [e.n_live for e in evs]
    assert lives == sorted(lives, reverse=True)
    # compaction gathers pow2 buckets: the dispatch width tracks, but
    # never undercuts, the live count
    assert all(e.gathered >= e.n_live for e in evs)
    assert all(e.heur_total is not None for e in evs)
    assert_same(base, traced)


def test_cycle_events_masked_needs_optin():
    """Without masked=True the masked driver emits nothing."""
    prob = _grid_batch(2, 3, 6, 6)
    evs = []
    with cycle_events(evs.append):              # compacted-only by default
        maxflow_grid_batch(prob, device=CPU)
    assert evs == []


def test_cycle_events_all_kinds_bitmatch():
    rng = np.random.default_rng(3)
    w = rng.integers(0, 9, (4, 5, 5)).astype(np.int32)
    adj = rng.random((4, 6, 6)) < 0.4
    for solve in (lambda: solve_assignment(w, device=CPU),
                  lambda: match_bipartite_batch(adj, device=CPU)):
        base = solve()
        evs = []
        with cycle_events(evs.append, masked=True):
            traced = solve()
        assert evs and evs[0].driver == "masked"
        assert evs[0].heur_total is None        # detail=False skips the read
        assert_same(base, traced)
        evs_c = []
        with cycle_events(evs_c.append):
            pass
        assert evs_c == []                      # hook uninstalled on exit


def test_trace_cycles_shim_still_works():
    prob = _grid_batch(4, 5, 6, 6)
    calls = []
    with trace_cycles(lambda c, n: calls.append((c, n))):
        maxflow_grid_batch(prob, compact=True, device=CPU)
    assert calls and calls[0][0] == 0 and calls[0][1] == 5
    assert all(isinstance(c, int) and isinstance(n, int) for c, n in calls)
    n_installed = len(calls)
    maxflow_grid_batch(prob, compact=True, device=CPU)
    assert len(calls) == n_installed, "shim hook leaked past its context"


def test_refill_session_bitmatch_and_spans():
    """A traced session equals the untraced one and the reference's
    traced session, and records the reference's spans: one ``bucket/pad``
    per payload, one ``device-solve`` per session."""
    rng = np.random.default_rng(5)
    ws = [rng.integers(0, 50, (5, 5)) for _ in range(6)]
    queue = list(ws[3:])

    def admit(n_free):
        out, queue[:] = queue[:n_free], queue[n_free:]
        return out

    base = RefillSolver("assignment", shape=(5,), capacity=3,
                        device=CPU).run(ws[:3], admit=admit)
    queue[:] = list(ws[3:])
    tr = Tracer()
    traced = RefillSolver("assignment", shape=(5,), capacity=3,
                          tracer=tr, device=CPU).run(ws[:3], admit=admit)
    queue[:] = list(ws[3:])
    jtr = jobs.Tracer()
    want = jrefill.RefillSolver("assignment", shape=(5,), capacity=3,
                                tracer=jtr).run(ws[:3], admit=admit)
    assert set(base) == set(traced) == set(want) == set(range(6))
    for i in base:
        assert_same(base[i], traced[i])
        assert_same(traced[i], want[i])
    names = [s.name for s in tr.spans()]
    assert names.count("bucket/pad") == 6       # one intake span per payload
    solve = [s for s in tr.spans() if s.name == "device-solve"]
    assert len(solve) == 1
    assert solve[0].attrs["driver"] == "refill"
    assert solve[0].attrs["kind"] == "assignment"
    assert solve[0].attrs["capacity"] == 3
    assert _structure(tr) == _structure(jtr)


# ----------------------------------------- sync engine: spans and bits

def test_traced_sync_flush_span_structure_equals_jax():
    """The same queue through both packages' traced ``SolverEngine``:
    equal results, and the same spans with the same attributes and the
    same parent links."""
    queue = _mixed_queue(20)
    tr, jtr = Tracer(), jobs.Tracer()
    eng = SolverEngine(tracer=tr, device=CPU)
    jeng = jengine.SolverEngine(tracer=jtr)
    tickets = [eng.submit(k, p) for k, p in queue]
    jtickets = [jeng.submit(k, _jax(k, [p])[0]) for k, p in queue]
    assert tickets == jtickets
    got, want = eng.flush(), jeng.flush()
    assert list(got) == list(want) == tickets
    for t in tickets:
        assert_same(got[t], want[t])
    assert _structure(tr) == _structure(jtr)
    names = {s.name for s in tr.spans()}
    assert names == {"submit", "bucket/pad", "device-solve"}


@pytest.mark.parametrize("compact", [False, True])
def test_traced_equals_untraced_sync_engine(compact):
    """Every kind, masked and compacted: a traced flush gives the
    untraced flush's bits and the reference's."""
    queue = _mixed_queue(21)
    out = []
    for tracer in (None, Tracer()):
        eng = SolverEngine(tracer=tracer, compact=compact, device=CPU)
        ts = [eng.submit(k, p) for k, p in queue]
        res = eng.flush()
        out.append([res[t] for t in ts])
    jeng = jengine.SolverEngine(compact=compact)
    jts = [jeng.submit(k, _jax(k, [p])[0]) for k, p in queue]
    jres = jeng.flush()
    for plain, traced, jt in zip(out[0], out[1], jts):
        assert_same(plain, traced)
        assert_same(traced, jres[jt])


def test_traced_equals_untraced_refill_sessions():
    """Every kind through ``SolverEngine.refill_session``: the engine's
    tracer rides into the session, and the bits do not move."""
    queue = _mixed_queue(22)
    shapes = {"maxflow": (6, 6), "assignment": (5,), "matching": (6, 7)}
    tr = Tracer()
    for kind, shape in shapes.items():
        payloads = [p for k, p in queue if k == kind]
        got = {}
        for tracer in (None, tr):
            eng = SolverEngine(tracer=tracer, device=CPU)
            got[tracer] = eng.refill_session(
                kind, shape=shape, capacity=3).run(payloads)
        want = jbatch.solve_batch(kind, _jax(kind, payloads), bucket="max")
        for i in range(len(payloads)):
            assert_same(got[None][i], got[tr][i])
            assert_same(got[tr][i], want[i])
    solves = [s for s in tr.spans() if s.name == "device-solve"]
    assert [s.attrs["kind"] for s in solves] == list(shapes)
    assert all(s.attrs["driver"] == "refill" for s in solves)


# --------------------------------------------- serving: lifecycle spans

def test_async_lifecycle_reconstructs_every_ticket():
    """A refill-enabled async session leaves a full
    submit/queue-wait/solve/resolve chain for every resolved ticket."""
    tr = Tracer()
    probs = _grid_problems(6, 9, 6, 6)
    with use_tracer(tr):
        eng = AsyncSolverEngine(max_batch=4, max_delay_ms=30.0, refill=True,
                                device=CPU)
    assert eng.tracer is tr                     # captured from the ambient var
    with eng:
        futs = [eng.submit("maxflow", p) for p in probs]
        results = [f.result(timeout=WAIT_S) for f in futs]
    assert all(r is not None for r in results)
    chains = _ticket_chains(tr)
    _check_lifecycle(chains, range(len(probs)))
    for t, spans in chains.items():
        for s in spans:
            if s.name == "queue-wait":
                assert s.attrs["trigger"] in {"size", "deadline", "manual",
                                              "drain", "refill"}
            if s.name == "solve":
                assert s.attrs["driver"] in {"masked", "compacted", "refill",
                                             "isolated"}
            assert s.attrs["kind"] == "maxflow"
    other = {s.name for s in tr.spans() if "ticket" not in s.attrs}
    assert {"bucket/pad", "device-solve"} <= other
    # the whole trace exports cleanly
    json.dumps(tr.to_chrome())
    assert prometheus_text(eng.metrics).startswith("# HELP repro_")


@pytest.mark.parametrize("n_lanes", [2, 3])
def test_async_lifecycle_on_cpu_lanes(n_lanes):
    """The reference's two-device session, on lanes of the CPU."""
    mesh = make_solver_mesh(n_lanes, device=CPU)
    tr = Tracer()
    probs = _grid_problems(7, 8, 6, 6)
    with AsyncSolverEngine(max_batch=4, max_delay_ms=30.0, refill=True,
                           mesh=mesh, tracer=tr, device=CPU) as eng:
        futs = [eng.submit("maxflow", p) for p in probs]
        for f in futs:
            assert f.result(timeout=WAIT_S) is not None
    _check_lifecycle(_ticket_chains(tr), range(len(probs)))


def _gated_refill_factory(real_kind, started, gate):
    """Wrap a kind's refill runtime so the FIRST finalize blocks on
    ``gate`` (signalling ``started``), pinning the session mid-solve so
    requests submitted meanwhile can only resolve via admission."""
    def factory(**kw):
        rt = real_kind.refill(**kw)

        def finalize(problems, st1, r):
            if not started.is_set():
                started.set()
                assert gate.wait(timeout=WAIT_S), "test gate never opened"
            return rt.finalize(problems, st1, r)

        return rt._replace(finalize=finalize)
    return factory


def test_refill_admission_spans(monkeypatch):
    """Mid-solve-admitted tickets trace ``trigger="refill"`` queue-waits,
    refill-driver solve spans, and a ``refill-admission`` span naming
    them."""
    started, gate = threading.Event(), threading.Event()
    real = kinds_mod.get_kind("assignment")
    monkeypatch.setitem(
        kinds_mod._REGISTRY, "assignment",
        real._replace(refill=_gated_refill_factory(real, started, gate)))
    rng = np.random.default_rng(8)
    ws = [rng.integers(0, 50, (5, 5)) for _ in range(4)]
    tr = Tracer()
    with AsyncSolverEngine(max_batch=4, max_delay_ms=LONG_DEADLINE_MS,
                           refill=True, tracer=tr, device=CPU) as eng:
        seed = eng.submit("assignment", ws[0])
        eng.flush_now()                          # open the session
        assert started.wait(timeout=WAIT_S), "session never reached finalize"
        futs = [eng.submit("assignment", w) for w in ws[1:]]
        gate.set()
        assert seed.result(timeout=WAIT_S) is not None
        for f in futs:
            assert f.result(timeout=WAIT_S) is not None
    chains = _ticket_chains(tr)
    _check_lifecycle(chains, range(4))
    admitted = set()
    for t, spans in chains.items():
        for s in spans:
            if s.name == "queue-wait" and s.attrs["trigger"] == "refill":
                admitted.add(t)
            if s.name == "solve" and t != 0:
                assert s.attrs["driver"] == "refill"
    assert admitted == {1, 2, 3}, \
        f"expected tickets 1-3 admitted mid-solve, got {admitted}"
    adm = [s for s in tr.spans() if s.name == "refill-admission"]
    assert adm, "no refill-admission span recorded"
    assert set().union(*(s.attrs["tickets"] for s in adm)) == {1, 2, 3}
    for s in adm:
        assert s.attrs["kind"] == "assignment"
        assert 1 <= s.attrs["admitted"] <= s.attrs["n_free"]


@pytest.mark.parametrize("refill", [False, True])
def test_async_serving_bitmatch_traced_vs_untraced(refill):
    """Tracing observes the serving path without steering it: the same
    mixed stream yields identical results with and without a tracer,
    equal to the reference's sync flush of the same per-kind chunks."""
    queue = _mixed_queue(9)

    def run(tracer):
        with AsyncSolverEngine(max_batch=3, max_delay_ms=LONG_DEADLINE_MS,
                               refill=refill, tracer=tracer,
                               device=CPU) as eng:
            futs = [eng.submit(k, p) for k, p in queue]
            return [f.result(timeout=WAIT_S) for f in futs]

    tr = Tracer()
    jeng = jengine.SolverEngine()
    jts = [jeng.submit(k, _jax(k, [p])[0]) for k, p in queue]
    want = jeng.flush()
    for plain, traced, jt in zip(run(None), run(tr), jts):
        assert_same(plain, traced)
        assert_same(traced, want[jt])
    assert tr.spans(), "traced run recorded nothing"


def test_instrumented_paths_deprecationwarning_free():
    """The non-shim engine/scheduler paths run clean under
    ``-W error::DeprecationWarning`` even while traced."""
    tr = Tracer()
    probs = _grid_problems(10, 3, 6, 6)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        blocking = SolverEngine(tracer=tr, device=CPU)
        tickets = [blocking.submit("maxflow", p) for p in probs]
        res = blocking.flush()
        assert set(tickets) <= set(res)
        with AsyncSolverEngine(max_batch=3, max_delay_ms=30.0,
                               tracer=tr, device=CPU) as eng:
            futs = [eng.submit("maxflow", p) for p in probs]
            for f in futs:
                assert f.result(timeout=WAIT_S) is not None
        prometheus_text(eng.metrics)
        json.dumps(tr.to_chrome())


# ----------------------------------------------------- metrics hygiene

def test_latency_window_empty_percentiles_are_none():
    win = LatencyWindow()
    assert win.percentiles() == {"p50": None, "p99": None}
    assert len(win) == 0


def test_latency_window_single_sample_percentiles_coincide():
    win = LatencyWindow()
    win.record(42.0)
    p = win.percentiles()
    assert p["p50"] == p["p99"] == 42.0


def test_ewma_alpha_bounds():
    for alpha in (0.0, -0.25, 1.5):
        with pytest.raises(ValueError, match="alpha"):
            Ewma(alpha=alpha)
    last_only = Ewma(alpha=1.0)                 # boundary: tracks the last x
    last_only.update(3.0)
    last_only.update(7.0)
    assert last_only.value == 7.0
    assert Ewma().value is None


def test_metrics_concurrent_hammer():
    """Racing recorders from many threads lose nothing: every counter
    lands exactly."""
    m = SchedulerMetrics()
    n_threads, n_iter = 8, 200
    barrier = threading.Barrier(n_threads)

    def worker(k):
        barrier.wait()
        for i in range(n_iter):
            m.record_submit(queue_depth=i)
            m.record_flush("size", queue_depth=0)
            m.record_dispatch("maxflow", compact=bool(i % 2), spread=0.1,
                              occupancy=0.5, rounds=4.0, heuristics=1.0)
            m.record_done(1.0)
            m.record_live_trace(i, n_live=2)
            m.record_refill_session("maxflow")
            m.record_refill_admit("maxflow", 2)
            m.record_refill_cycle("maxflow", 0.75)
            m.record_cancelled()

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
        assert not t.is_alive()
    total = n_threads * n_iter
    snap = m.snapshot()
    assert snap["tickets"] == {"submitted": total, "completed": total,
                               "cancelled": total}
    assert snap["flushes_by_trigger"] == {"size": total}
    assert snap["dispatches"] == {"maxflow:masked": total // 2,
                                  "maxflow:compacted": total // 2}
    assert snap["compact_cycles"] == total
    assert snap["compact_live_mean"] == 2.0
    assert snap["refill"]["sessions"] == {"maxflow": total}
    assert snap["refill"]["admitted"] == {"maxflow": 2 * total}
    assert snap["refill"]["utilization"] == pytest.approx(0.75)
    assert snap["latency_ms"]["p50"] == 1.0


def test_snapshot_is_a_deep_copy():
    m = SchedulerMetrics()
    m.record_submit(queue_depth=3)
    m.record_refill_admit("maxflow", 2)
    m.record_dispatch("maxflow", compact=False, spread=0.5, occupancy=1.0)
    snap = m.snapshot()
    snap["tickets"]["submitted"] = 10 ** 6
    snap["refill"]["admitted"]["maxflow"] = -1
    snap["refill"]["sessions"]["injected"] = 99
    snap["spread_ewma"]["maxflow"] = -42.0
    fresh = m.snapshot()
    assert fresh["tickets"]["submitted"] == 1
    assert fresh["refill"]["admitted"] == {"maxflow": 2}
    assert "injected" not in fresh["refill"]["sessions"]
    assert fresh["spread_ewma"]["maxflow"] == 0.5


# ------------------------------------------------- prometheus exposition

# every snapshot key maps to the exposition family its renderer emits; the
# two-way assertion below forces this table (and the renderer registry) to
# grow whenever the snapshot does
FAMILY_OF = {
    "queue_depth": "repro_queue_depth",
    "tickets": "repro_tickets_total",
    "flushes_by_trigger": "repro_flushes_total",
    "dispatches": "repro_dispatches_total",
    "latency_ms": "repro_ticket_latency_ms",
    "latency_samples": "repro_ticket_latency_samples",
    "compact_cycles": "repro_compact_cycles_total",
    "compact_live_mean": "repro_compact_live_mean",
    "refill": "repro_refill_sessions_total",
    "warm": "repro_warm_cache_lookups_total",
    "spread_ewma": "repro_spread_ewma",
    "occupancy_ewma": "repro_occupancy_ewma",
    "rounds_ewma": "repro_rounds_ewma",
    "heuristics_ewma": "repro_heuristics_ewma",
}


def _populated_metrics(cls=SchedulerMetrics):
    m = cls()
    m.record_submit(queue_depth=2)
    m.record_flush("deadline", queue_depth=0)
    m.record_dispatch("maxflow", compact=True, spread=0.3, occupancy=0.9,
                      rounds=7.0, heuristics=2.0)
    m.record_done(12.5)
    m.record_live_trace(0, n_live=4)
    m.record_refill_session("maxflow")
    m.record_refill_admit("maxflow", 3)
    m.record_refill_cycle("maxflow", 0.5)
    m.record_cache_lookup(True)
    m.record_cache_lookup(False)
    m.record_warm("maxflow", 2, 6, rounds_saved=3.0)
    return m


def test_prometheus_renders_every_snapshot_field():
    m = _populated_metrics()
    snap = m.snapshot()
    assert set(snap) == set(FAMILY_OF), (
        "snapshot keys and the exposition-family table diverged: teach "
        "repro_torch.obs.export (and this test) about the new field")
    text = prometheus_text(m)
    for key, family in FAMILY_OF.items():
        assert f"# HELP {family} " in text, f"{key} not rendered"
        assert f"# TYPE {family} " in text
    # spot-check labels and values
    assert 'repro_tickets_total{status="submitted"} 1' in text
    assert 'repro_flushes_total{trigger="deadline"} 1' in text
    assert 'repro_dispatches_total{kind="maxflow",driver="compacted"} 1' \
        in text
    assert 'repro_ticket_latency_ms{quantile="0.5"} 12.5' in text
    assert 'repro_refill_admitted_total{kind="maxflow"} 3' in text
    assert 'repro_warm_cache_lookups_total{result="hit"} 1' in text
    assert 'repro_warm_solves_total{init="warm"} 2' in text
    assert 'repro_warm_fraction 0.25' in text
    assert 'repro_warm_rounds_saved_ewma{kind="maxflow"} 3' in text
    assert text.endswith("\n")


def test_prometheus_accepts_snapshot_dict_and_skips_none():
    text = prometheus_text(SchedulerMetrics().snapshot())
    # empty window / unobserved EWMAs: family headers stay, no samples
    assert "# HELP repro_ticket_latency_ms " in text
    assert "repro_ticket_latency_ms{" not in text
    assert "repro_compact_live_mean\n" not in text.replace("gauge\n", "")
    assert "repro_queue_depth 0" in text


def test_prometheus_unknown_snapshot_key_raises():
    snap = SchedulerMetrics().snapshot()
    snap["brand_new_metric"] = 1
    with pytest.raises(KeyError, match="brand_new_metric"):
        prometheus_text(snap)


def test_prometheus_text_is_the_references_byte_for_byte():
    """The same snapshot dict renders to the reference's text; the two
    packages' metrics fed the same records give the same snapshot."""
    registered_kinds()                   # both registries hold every kind
    jkinds.registered_kinds()
    for build in (lambda c: c(), _populated_metrics):
        snap = build(SchedulerMetrics).snapshot()
        jsnap = build(jmetrics.SchedulerMetrics).snapshot()
        assert snap == jsnap
        assert prometheus_text(snap) == jobs.prometheus_text(snap)


def test_prometheus_text_of_a_served_stream_is_the_references():
    """The snapshot of a real async session (every kind, refill, warm)
    renders byte for byte as the reference renders it."""
    queue = _mixed_queue(23)
    with AsyncSolverEngine(max_batch=3, max_delay_ms=LONG_DEADLINE_MS,
                           refill=True, device=CPU) as eng:
        futs = [eng.submit(k, p) for k, p in queue]
        for f in futs:
            f.result(timeout=WAIT_S)
        # a warm re-solve of ticket 1 (an assignment) from its cached prices
        warm = eng.submit("assignment", queue[1][1], base=1)
        eng.flush_now()
        warm.result(timeout=WAIT_S)
    snap = eng.metrics.snapshot()        # lanes joined: every record in
    assert snap["tickets"]["completed"] == len(queue) + 1
    assert snap["warm"]["warm_solves"] == 1
    assert prometheus_text(snap) == jobs.prometheus_text(snap)
