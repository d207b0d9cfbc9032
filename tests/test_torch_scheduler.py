"""The async serving scheduler (``AsyncSolverEngine``, ROADMAP M8): the
port against the JAX package.

Ported case for case from ``tests/test_scheduler.py`` (bit-match of the
futures with the sync flush and single solves, masked, compacted, on
lanes and with exact buckets; size and deadline triggers; draining and
cancelling shutdown; validation before a future exists; poison isolation;
the adaptive masked-vs-compacted choice and its override; the cycle trace
hook; the metrics primitives; ``scheduler_lanes``), from the async and
engine cases of ``tests/test_refill.py`` (mid-solve admission with
per-ticket resolution, a poisoned admission, a session that aborts,
refill bit-match, refill on lanes, the deprecated spellings through the
refill path, ``SolverEngine.refill_session``, the refill metrics, the
fixed-seed ragged streams), ``tests/test_warm.py`` (warm submissions,
masked and refill) and ``tests/test_matching.py`` (the matching kind).
The reference's forced-multi-device relaunch (ROADMAP F1) is here 2 and 3
lanes of the CPU through ``make_solver_mesh(n, device="cpu")``.

Every future's result equals the port's sync ``flush`` and the
reference's sync ``flush`` of the same chunks, leaf for leaf with dtypes
and counters (``assert_same``, exact), and ``choose_driver`` decides as
the reference's does. The tests wait on events and futures, never on
sleeps; ``WAIT_S`` only guards against a hang, and no assertion reads a
wall-clock duration. On the CPU a lane has no CUDA stream; the card tests
(``tests/test_torch_kernels_card.py``) drive lanes on their own streams.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same

import repro.core.warm as jwarm
import repro.serve.engine as jengine
import repro.serve.scheduler as jsched
import repro_torch.core.kinds as kinds_mod
from repro.core.maxflow.grid import GridProblem as JGridProblem
from repro_torch.core.assignment.ref import optimal_weight
from repro_torch.core.batch import solve_batch, solve_maxflow_batch
from repro_torch.core.matching.ref import hopcroft_karp, random_bipartite
from repro_torch.core.maxflow.grid import GridProblem
from repro_torch.core.maxflow.ref import maxflow_grid_ref, random_grid_problem
from repro_torch.core.solver_loop import trace_cycles
from repro_torch.core.warm import GraphDelta, apply_delta
from repro_torch.launch.mesh import (make_solver_mesh, scheduler_lanes,
                                     shard_count)
from repro_torch.serve.engine import SolverEngine
from repro_torch.serve.metrics import (ConvergenceStats, Ewma, LatencyWindow,
                                       SchedulerMetrics)
from repro_torch.serve.scheduler import AsyncSolverEngine, choose_driver

CPU = "cpu"
WAIT_S = 120.0
LONG_DEADLINE_MS = 600_000.0


def _grid(rng, h, w, easy=False):
    cap, cs, ct = random_grid_problem(rng, h, w)
    if easy:
        cs = np.minimum(cs, 1.0)
    return GridProblem(cap, cs, ct)


def _grid_problems(seed, B, H, W):
    rng = np.random.default_rng(seed)
    return [_grid(rng, H, W) for _ in range(B)]


def _ragged_grid_problems(seed, B, H, W):
    """Most instances converge in the first cycles, a few run long: the
    convergence-spread signal adaptive dispatch keys on."""
    rng = np.random.default_rng(seed)
    return [_grid(rng, H, W, easy=bool(i % 4)) for i in range(B)]


def _jax(kind, payload):
    if kind == "maxflow":
        return JGridProblem(*map(jnp.asarray, payload))
    return payload


def _sync_chunks(kind, payloads, chunk, **kw):
    """The port's and the reference's sync flush of ``payloads`` in
    ``chunk``-sized rounds (the scheduler's size-trigger chunks); the two
    must agree leaf for leaf. Returns the port's results in order."""
    eng = SolverEngine(device=CPU, **kw)
    jeng = jengine.SolverEngine(**kw)
    out = []
    for lo in range(0, len(payloads), chunk):
        ts = [eng.submit(kind, p) for p in payloads[lo:lo + chunk]]
        jts = [jeng.submit(kind, _jax(kind, p))
               for p in payloads[lo:lo + chunk]]
        got, want = eng.flush(), jeng.flush()
        for t, jt in zip(ts, jts):
            assert_same(got[t], want[jt])
            out.append(got[t])
    return out


def _mf_ref(p) -> float:
    return maxflow_grid_ref(np.asarray(p.cap_nbr), np.asarray(p.cap_src),
                            np.asarray(p.cap_sink))


# ------------------------------------------------------------- bit-match

def _bitmatch_stream(async_kw: dict, sync_kw: dict, chunk: int = 4):
    """Submit a recorded stream both ways; futures must equal the port's
    and the reference's synchronous flush of the same chunks."""
    probs = _grid_problems(0, 2 * chunk, 8, 8)
    ws = [np.random.default_rng(i).integers(0, 50, (6, 6))
          for i in range(chunk)]
    with AsyncSolverEngine(max_batch=chunk, max_delay_ms=LONG_DEADLINE_MS,
                           device=CPU, **async_kw) as eng:
        f_futs = [eng.submit("maxflow", p) for p in probs]
        a_futs = [eng.submit("assignment", w) for w in ws]
        eng.flush_now()                  # the assignment chunk is short
        f_res = [f.result(timeout=WAIT_S) for f in f_futs]
        a_res = [f.result(timeout=WAIT_S) for f in a_futs]
    base_f = _sync_chunks("maxflow", probs, chunk, **sync_kw)
    base_a = _sync_chunks("assignment", ws, chunk, **sync_kw)
    for got, want in zip(f_res + a_res, base_f + base_a):
        assert_same(got, want)
    return f_res, a_res, probs, ws


def test_async_bitmatch_plain_vs_sync_and_single():
    f_res, a_res, probs, ws = _bitmatch_stream({"dispatch": "masked"}, {})
    # ... and the loop-of-single-solves layer of the contract
    for got, p in zip(f_res, probs):
        assert_same(got, solve_batch("maxflow", [p], device=CPU)[0])
    for got, w in zip(a_res, ws):
        assert_same(got, solve_batch("assignment", [w], device=CPU)[0])


def test_async_bitmatch_compacted():
    _bitmatch_stream({"dispatch": "compacted"}, {"compact": True})


@pytest.mark.parametrize("n", [2, 3])
def test_async_bitmatch_on_lanes(n):
    """Lanes (disjoint sub-sets when the set is big enough) == the sync
    flush without lanes, the port's and the reference's."""
    _bitmatch_stream({"mesh": make_solver_mesh(n, device=CPU),
                      "n_lanes": 2, "dispatch": "masked"}, {})


def test_async_bitmatch_ragged_exact_bucket():
    """bucket="exact" makes results independent of batch composition:
    async == single solves for a ragged shape mix."""
    rng = np.random.default_rng(3)
    shapes = [(5, 5), (8, 8), (4, 7), (8, 8), (5, 5), (4, 7)]
    probs = [_grid(rng, h, w) for h, w in shapes]
    with AsyncSolverEngine(max_batch=3, max_delay_ms=LONG_DEADLINE_MS,
                           bucket="exact", dispatch="masked",
                           device=CPU) as eng:
        futs = [eng.submit("maxflow", p) for p in probs]
        res = [f.result(timeout=WAIT_S) for f in futs]
    for got, p in zip(res, probs):
        want = _sync_chunks("maxflow", [p], 1, bucket="exact")[0]
        assert_same(got, want)


# ------------------------------------------------------------- triggers

def test_deadline_trigger_completes_without_flush():
    """A lone request (far below max_batch) completes with NO manual
    flush: the background thread flushed it on its deadline."""
    [p] = _grid_problems(4, 1, 8, 8)
    with AsyncSolverEngine(max_batch=64, max_delay_ms=250.0,
                           device=CPU) as eng:
        res = eng.submit("maxflow", p).result(timeout=WAIT_S)
        snap = eng.metrics.snapshot()
    assert bool(res.converged)
    assert snap["flushes_by_trigger"].get("deadline", 0) >= 1
    assert snap["flushes_by_trigger"].get("size", 0) == 0


def test_size_trigger_fires_at_max_batch():
    probs = _grid_problems(5, 4, 8, 8)
    with AsyncSolverEngine(max_batch=4, max_delay_ms=LONG_DEADLINE_MS,
                           device=CPU) as eng:
        eng.flush_now()          # empty queue: must NOT arm a stale manual
        futs = [eng.submit("maxflow", p) for p in probs]
        res = [f.result(timeout=WAIT_S) for f in futs]
        snap = eng.metrics.snapshot()
    assert all(bool(r.converged) for r in res)
    # the batch flushed on SIZE: a stale manual flag would have dispatched
    # the first submission as a singleton 'manual' batch instead
    assert snap["flushes_by_trigger"].get("manual", 0) == 0
    assert snap["flushes_by_trigger"].get("size", 0) >= 1
    assert snap["tickets"]["completed"] == 4
    assert snap["latency_ms"]["p50"] is not None
    assert snap["latency_ms"]["p99"] >= snap["latency_ms"]["p50"]


def test_shutdown_drains_pending_futures():
    probs = _grid_problems(6, 3, 8, 8)
    eng = AsyncSolverEngine(max_batch=64, max_delay_ms=LONG_DEADLINE_MS,
                            device=CPU)
    futs = [eng.submit("maxflow", p) for p in probs]
    eng.close(drain=True)                # must not hang, must resolve all
    for f, want in zip(futs, _sync_chunks("maxflow", probs, 3)):
        assert_same(f.result(timeout=WAIT_S), want)
    assert eng.metrics.snapshot()["flushes_by_trigger"].get("drain", 0) >= 1
    eng.close()                          # idempotent


def test_shutdown_cancels_when_not_draining():
    probs = _grid_problems(7, 2, 8, 8)
    eng = AsyncSolverEngine(max_batch=64, max_delay_ms=LONG_DEADLINE_MS,
                            device=CPU)
    futs = [eng.submit("maxflow", p) for p in probs]
    eng.close(drain=False)
    assert all(f.cancelled() for f in futs)
    assert eng.metrics.snapshot()["tickets"]["cancelled"] == 2
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit("maxflow", probs[0])


def test_submit_validates_before_future_exists():
    good = _grid_problems(8, 1, 6, 6)[0]
    bad = GridProblem(good.cap_nbr, -good.cap_src, good.cap_sink)
    with AsyncSolverEngine(max_batch=4, max_delay_ms=LONG_DEADLINE_MS,
                           device=CPU) as eng:
        with pytest.raises(ValueError, match="negative"):
            eng.submit("maxflow", bad)
        with pytest.raises(ValueError, match="malformed assignment"):
            eng.submit("assignment", np.ones((3, 4)))
        assert eng.pending() == 0
        assert eng.metrics.snapshot()["tickets"].get("submitted", 0) == 0


def test_engine_owns_its_device(monkeypatch):
    """The card unless told otherwise; ``solver_kw`` names no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        AsyncSolverEngine()
    with pytest.raises(ValueError, match="device"):
        AsyncSolverEngine(device=CPU,
                          solver_kw={"maxflow": {"device": CPU}})


# ------------------------------------------------------------- isolation

def test_poisoned_request_fails_only_its_own_future(monkeypatch):
    """A request that detonates the batched dispatch gets its exception;
    every batch-mate still resolves, solved alone through the same path."""
    POISON = 777

    real = kinds_mod.get_kind("assignment")

    def maybe_boom(prep, **kw):
        if any(int(np.asarray(o).ravel()[0]) == POISON
               for o in prep.originals):
            raise RuntimeError("poisoned dispatch")
        return real.solve_prepared(prep, **kw)

    monkeypatch.setitem(kinds_mod._REGISTRY, "assignment",
                        real._replace(solve_prepared=maybe_boom))

    rng = np.random.default_rng(9)
    ws = [rng.integers(0, 50, (5, 5)) for _ in range(3)]
    poisoned = ws[1].copy()
    poisoned.flat[0] = POISON
    stream = [ws[0], poisoned, ws[2]]
    with AsyncSolverEngine(max_batch=3, max_delay_ms=LONG_DEADLINE_MS,
                           device=CPU) as eng:
        futs = [eng.submit("assignment", w) for w in stream]
        with pytest.raises(RuntimeError, match="poisoned"):
            futs[1].result(timeout=WAIT_S)
        for f, w in ((futs[0], ws[0]), (futs[2], ws[2])):
            got = f.result(timeout=WAIT_S)
            assert_same(got, _sync_chunks("assignment", [w], 1)[0])
        snap = eng.metrics.snapshot()
    assert snap["tickets"]["failed"] == 1
    assert snap["tickets"]["completed"] == 2


# ----------------------------------------------------- adaptive dispatch

def test_adaptive_dispatch_chooses_compaction_on_ragged_stream():
    """First chunk runs masked (no history); once the spread EWMA builds,
    ragged-convergence chunks flip to the compacted driver, with the
    masked driver's bits."""
    probs = _ragged_grid_problems(10, 12, 8, 8)
    res = []
    with AsyncSolverEngine(max_batch=4, max_delay_ms=LONG_DEADLINE_MS,
                           dispatch="adaptive", spread_threshold=0.1,
                           min_compact_batch=2, device=CPU) as eng:
        for lo in range(0, len(probs), 4):
            futs = [eng.submit("maxflow", p) for p in probs[lo:lo + 4]]
            res += [f.result(timeout=WAIT_S) for f in futs]  # serialize
        m = eng.metrics
        spread = m.convergence.spread("maxflow")
        masked = m.dispatch_count("maxflow", "masked")
        compacted = m.dispatch_count("maxflow", "compacted")
    assert spread is not None and spread > 0.1, \
        "stream not ragged: adaptive path untested"
    assert masked >= 1, "first dispatch (no history) should stay masked"
    assert compacted >= 1, "EWMA never flipped the driver to compacted"
    for got, want in zip(res, _sync_chunks("maxflow", probs, 4)):
        assert_same(got, want)


def test_adaptive_dispatch_stays_masked_on_uniform_stream():
    # a truly uniform stream: the same instance repeated, identical
    # trajectories, zero round spread, so compaction never pays
    probs = _grid_problems(11, 1, 8, 8) * 8
    with AsyncSolverEngine(max_batch=4, max_delay_ms=LONG_DEADLINE_MS,
                           dispatch="adaptive", spread_threshold=0.1,
                           min_compact_batch=2, device=CPU) as eng:
        for lo in range(0, len(probs), 4):
            futs = [eng.submit("maxflow", p) for p in probs[lo:lo + 4]]
            [f.result(timeout=WAIT_S) for f in futs]
        assert eng.metrics.dispatch_count("maxflow", "compacted") == 0


def test_forced_dispatch_override():
    probs = _grid_problems(12, 4, 8, 8)
    with AsyncSolverEngine(max_batch=4, max_delay_ms=LONG_DEADLINE_MS,
                           dispatch="compacted", device=CPU) as eng:
        futs = [eng.submit("maxflow", p) for p in probs]
        [f.result(timeout=WAIT_S) for f in futs]
        assert eng.metrics.dispatch_count("maxflow", "masked") == 0
        assert eng.metrics.dispatch_count("maxflow", "compacted") >= 1
    with pytest.raises(ValueError, match="dispatch"):
        AsyncSolverEngine(dispatch="warp-speed", device=CPU)


def test_choose_driver_policy_table():
    kw = dict(threshold=0.25, min_batch=4)
    assert choose_driver(None, 8, forced="adaptive", **kw) is False
    assert choose_driver(0.1, 8, forced="adaptive", **kw) is False
    assert choose_driver(0.5, 8, forced="adaptive", **kw) is True
    assert choose_driver(0.5, 2, forced="adaptive", **kw) is False  # tiny
    assert choose_driver(0.5, 2, forced="compacted", **kw) is True
    assert choose_driver(0.9, 64, forced="masked", **kw) is False
    # the whole table, decision for decision, against the reference's
    for forced in ("adaptive", "masked", "compacted"):
        for spread in (None, 0.0, 0.25, 0.2500001, 0.5, 1.0):
            for n_real in (0, 1, 3, 4, 5, 64):
                for threshold in (0.0, 0.25, 0.9):
                    for min_batch in (1, 4, 8):
                        args = (spread, n_real)
                        kw = dict(threshold=threshold, min_batch=min_batch,
                                  forced=forced)
                        assert choose_driver(*args, **kw) == \
                            jsched.choose_driver(*args, **kw)
    with pytest.raises(ValueError, match="dispatch"):
        choose_driver(None, 1, threshold=0.1, min_batch=1, forced="x")


# ------------------------------------------------- trace hook + metrics

def test_cycle_trace_hook_sees_live_set_shrink():
    """``trace_cycles``: the compacted driver reports (cycle, n_live) per
    host cycle, and the live set only shrinks."""
    probs = _ragged_grid_problems(13, 6, 8, 8)
    calls: list[tuple[int, int]] = []
    with trace_cycles(lambda c, n: calls.append((c, n))):
        solve_maxflow_batch(probs, compact=True, device=CPU)
    assert calls, "compacted solve traced no cycles"
    assert calls[0] == (0, 6)
    lives = [n for _, n in calls]
    assert all(a >= b for a, b in zip(lives, lives[1:])), \
        f"live set grew: {lives}"
    # hook uninstalled outside the context
    calls.clear()
    solve_maxflow_batch(probs, compact=True, device=CPU)
    assert not calls


def test_metrics_primitives():
    e = Ewma(alpha=0.5)
    assert e.value is None
    assert e.update(1.0) == 1.0
    assert e.update(0.0) == 0.5
    with pytest.raises(ValueError):
        Ewma(alpha=0.0)

    w = LatencyWindow(maxlen=4)
    assert w.percentiles()["p50"] is None
    for x in (1.0, 2.0, 3.0, 4.0, 100.0):   # 1.0 evicted
        w.record(x)
    p = w.percentiles()
    assert p["p50"] == 3.5 and p["p99"] > 4.0 and len(w) == 4

    c = ConvergenceStats(alpha=1.0)
    assert c.spread("maxflow") is None
    c.observe("maxflow", spread=0.5, occupancy=0.75)
    assert c.spread("maxflow") == 0.5 and c.occupancy("maxflow") == 0.75

    m = SchedulerMetrics()
    m.record_submit(3)
    m.record_dispatch("maxflow", compact=True, spread=0.4, occupancy=0.5)
    m.record_live_trace(0, 8)
    m.record_live_trace(1, 4)
    snap = m.snapshot()
    assert snap["queue_depth"] == 3
    assert snap["dispatches"] == {"maxflow:compacted": 1}
    assert snap["compact_cycles"] == 2 and snap["compact_live_mean"] == 6.0


# ------------------------------------------------------ scheduler lanes

def test_scheduler_lanes_no_mesh():
    assert scheduler_lanes(None, None, 3) == [None, None, None]
    with pytest.raises(ValueError, match="n_lanes"):
        scheduler_lanes(None, None, 0)


def test_scheduler_lanes_single_device_shares_mesh():
    mesh = make_solver_mesh(1, device=CPU)
    lanes = scheduler_lanes(mesh, None, 2)
    assert len(lanes) == 2 and all(l is mesh for l in lanes)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_scheduler_lanes_split_devices_disjoint(n):
    mesh = make_solver_mesh(n, device=CPU)
    lanes = scheduler_lanes(mesh, None, 2)
    assert len(lanes) == 2
    # disjoint by position: the sub-sets tile the lane tuple in order
    assert tuple(d for l in lanes for d in l.devices) == mesh.devices
    assert sum(shard_count(l) for l in lanes) == n


def test_cpu_lanes_have_no_streams():
    """On the CPU a lane solves on no CUDA stream; the path is the same."""
    with AsyncSolverEngine(n_lanes=2, device=CPU) as eng:
        assert [lane.streams for lane in eng._lanes] == [(), ()]
        assert eng._readers == ()


# ----------------------------------------- continuous batching (refill)

def _gated_refill_factory(real_kind, started, gate, poison=None):
    """Wrap a kind's refill runtime so the FIRST finalize blocks on
    ``gate`` (signalling ``started``), pinning the session mid-solve so a
    test can submit requests that can only complete via admission, and,
    optionally, so cropping a ``poison``-marked payload raises."""
    def factory(**kw):
        rt = real_kind.refill(**kw)

        def finalize(problems, st1, r):
            if not started.is_set():
                started.set()
                assert gate.wait(timeout=WAIT_S), "test gate never opened"
            return rt.finalize(problems, st1, r)

        def crop(res1, shape, payload):
            if poison is not None \
                    and int(np.asarray(payload).ravel()[0]) == poison:
                raise RuntimeError("poisoned crop")
            return rt.crop(res1, shape, payload)

        return rt._replace(finalize=finalize, crop=crop)
    return factory


def test_async_refill_admits_mid_solve_and_resolves_per_instance(monkeypatch):
    """The session is pinned inside the seed's finalize; requests
    submitted meanwhile can ONLY complete through cycle-boundary
    admission, and the seed's future resolves FIRST: per instance, not at
    session drain. Every result is the closed batch's at the session's
    padding shape."""
    started, gate = threading.Event(), threading.Event()
    real = kinds_mod.get_kind("assignment")
    monkeypatch.setitem(
        kinds_mod._REGISTRY, "assignment",
        real._replace(refill=_gated_refill_factory(real, started, gate)))

    rng = np.random.default_rng(8)
    ws = [rng.integers(0, 50, (5, 5)) for _ in range(4)]
    order = []
    with AsyncSolverEngine(max_batch=4, max_delay_ms=LONG_DEADLINE_MS,
                           refill=True, device=CPU) as eng:
        seed_fut = eng.submit("assignment", ws[0])
        seed_fut.add_done_callback(lambda f: order.append("seed"))
        eng.flush_now()                          # open the session
        assert started.wait(timeout=WAIT_S), "session never reached finalize"
        # the session is pinned: these can only resolve via admission
        futs = [eng.submit("assignment", w) for w in ws[1:]]
        for i, f in enumerate(futs):
            f.add_done_callback(lambda _f, i=i: order.append(i))
        gate.set()
        res = [seed_fut.result(timeout=WAIT_S)]
        res += [f.result(timeout=WAIT_S) for f in futs]
        snap = eng.metrics.snapshot()
    monkeypatch.setitem(kinds_mod._REGISTRY, "assignment", real)
    for got, want in zip(res, _sync_chunks("assignment", ws, 4)):
        assert_same(got, want)
    for w, r in zip(ws, res):
        assert int(r.weight) == optimal_weight(w)
    assert order[0] == "seed", \
        f"seed future resolved at {order.index('seed')}, not first: {order}"
    assert snap["refill"]["sessions"].get("assignment", 0) >= 1
    assert snap["refill"]["admitted"].get("assignment", 0) >= 3
    assert snap["refill"]["utilization"] is not None
    assert snap["tickets"]["completed"] == 4


def test_async_refill_poison_admitted_mid_solve_fails_alone(monkeypatch):
    """A poisoned request ADMITTED into an in-flight session fails only
    its own future; the seed and the other admissions still resolve."""
    POISON = 777
    started, gate = threading.Event(), threading.Event()
    real = kinds_mod.get_kind("assignment")
    monkeypatch.setitem(
        kinds_mod._REGISTRY, "assignment",
        real._replace(refill=_gated_refill_factory(
            real, started, gate, poison=POISON)))

    rng = np.random.default_rng(9)
    ws = [rng.integers(0, 50, (5, 5)) for _ in range(3)]
    poisoned = ws[1].copy()
    poisoned.flat[0] = POISON
    with AsyncSolverEngine(max_batch=8, max_delay_ms=LONG_DEADLINE_MS,
                           refill=True, device=CPU) as eng:
        seed_fut = eng.submit("assignment", ws[0])
        eng.flush_now()
        assert started.wait(timeout=WAIT_S)
        futs = [eng.submit("assignment", w) for w in (poisoned, ws[2])]
        gate.set()
        with pytest.raises(RuntimeError, match="poisoned"):
            futs[0].result(timeout=WAIT_S)
        assert int(futs[1].result(timeout=WAIT_S).weight) == \
            optimal_weight(ws[2])
        assert int(seed_fut.result(timeout=WAIT_S).weight) == \
            optimal_weight(ws[0])
        snap = eng.metrics.snapshot()
    assert snap["tickets"]["failed"] == 1
    assert snap["tickets"]["completed"] == 2


def test_async_refill_session_abort_falls_back_to_solo(monkeypatch):
    """If the session itself aborts (init raises), the lane's poison
    isolation solves every request alone through the closed-batch path:
    no future is lost, and each equals its own solve."""
    real = kinds_mod.get_kind("assignment")

    def broken_factory(**kw):
        rt = real.refill(**kw)

        def boom(stacked):
            raise RuntimeError("session init detonated")
        return rt._replace(init=boom)

    monkeypatch.setitem(kinds_mod._REGISTRY, "assignment",
                        real._replace(refill=broken_factory))
    rng = np.random.default_rng(10)
    ws = [rng.integers(0, 50, (5, 5)) for _ in range(3)]
    with AsyncSolverEngine(max_batch=3, max_delay_ms=LONG_DEADLINE_MS,
                           refill=True, device=CPU) as eng:
        futs = [eng.submit("assignment", w) for w in ws]
        res = [f.result(timeout=WAIT_S) for f in futs]
    monkeypatch.setitem(kinds_mod._REGISTRY, "assignment", real)
    for w, r in zip(ws, res):
        assert_same(r, _sync_chunks("assignment", [w], 1)[0])


@pytest.mark.parametrize("n_lanes", [1, 2])
def test_async_refill_bitmatches_stream(n_lanes):
    """refill=True serving == the port's and the reference's sync flush of
    the same chunks, for a mixed-kind stream."""
    rng = np.random.default_rng(11)
    probs = [_grid(rng, 8, 8, easy=bool(i % 2)) for i in range(8)]
    adjs = [random_bipartite(rng, 6, 7, 0.3) for _ in range(4)]
    with AsyncSolverEngine(max_batch=4, max_delay_ms=LONG_DEADLINE_MS,
                           refill=True, n_lanes=n_lanes, device=CPU) as eng:
        f_futs = [eng.submit("maxflow", p) for p in probs]
        m_futs = [eng.submit("matching", a) for a in adjs]
        eng.flush_now()
        f_res = [f.result(timeout=WAIT_S) for f in f_futs]
        m_res = [f.result(timeout=WAIT_S) for f in m_futs]
    snap = eng.metrics.snapshot()
    assert sum(snap["refill"]["sessions"].values()) >= 2
    for got, want in zip(f_res, _sync_chunks("maxflow", probs, 4)):
        assert_same(got, want)
    for got, want in zip(m_res, _sync_chunks("matching", adjs, 4)):
        assert_same(got, want)


@pytest.mark.parametrize("n", [2, 3])
def test_async_refill_on_lanes(n):
    """Continuous batching on a lane set: sessions run on each lane's
    sub-set with capacity rounded to its lane count; results match single
    solves and the oracle."""
    rng = np.random.default_rng(12 + n)
    probs = [_grid(rng, 8, 8, easy=bool(i % 2)) for i in range(10)]
    with AsyncSolverEngine(max_batch=4, max_delay_ms=LONG_DEADLINE_MS,
                           refill=True, mesh=make_solver_mesh(n, device=CPU),
                           n_lanes=2, device=CPU) as eng:
        futs = [eng.submit("maxflow", p) for p in probs]
        eng.flush_now()
        res = [f.result(timeout=WAIT_S) for f in futs]
        snap = eng.metrics.snapshot()
    assert snap["refill"]["sessions"].get("maxflow", 0) >= 1
    for p, r in zip(probs, res):
        assert float(r.flow) == _mf_ref(p)


def test_deprecated_spellings_flow_through_refill_path():
    """``submit_maxflow`` / ``submit_assignment`` and the ``*_kw`` ctor
    spellings warn and delegate INTO the refill path: the session uses the
    deprecated kwargs and the refill counters prove the route taken."""
    rng = np.random.default_rng(13)
    probs = [_grid(rng, 12, 12) for _ in range(2)]
    ws = [rng.integers(0, 50, (5, 5)) for _ in range(2)]
    # max_rounds far below what these instances need: if the deprecated
    # kwargs were dropped on the refill path, the solves would CONVERGE;
    # the unconverged results below prove the knob flowed through
    assert all(int(r.rounds) > 32 for r in solve_batch(
        "maxflow", probs, bucket="max", device=CPU))
    with pytest.warns(DeprecationWarning, match="maxflow_kw"):
        eng = AsyncSolverEngine(max_batch=2, max_delay_ms=LONG_DEADLINE_MS,
                                refill=True, maxflow_kw={"max_rounds": 32},
                                device=CPU)
    with eng:
        with pytest.warns(DeprecationWarning, match="submit_maxflow"):
            f_futs = [eng.submit_maxflow(p) for p in probs]
        with pytest.warns(DeprecationWarning, match="submit_assignment"):
            a_futs = [eng.submit_assignment(w) for w in ws]
        f_res = [f.result(timeout=WAIT_S) for f in f_futs]
        a_res = [f.result(timeout=WAIT_S) for f in a_futs]
    snap = eng.metrics.snapshot()
    assert snap["refill"]["sessions"].get("maxflow", 0) >= 1
    assert snap["refill"]["sessions"].get("assignment", 0) >= 1
    assert all(not bool(r.converged) and int(r.rounds) == 32 for r in f_res)
    want = _sync_chunks("maxflow", probs, 2,
                        solver_kw={"maxflow": {"max_rounds": 32}})
    for got_i, want_i in zip(f_res, want):
        assert_same(got_i, want_i)
    for got_i, want_i in zip(a_res, _sync_chunks("assignment", ws, 2)):
        assert_same(got_i, want_i)


def test_sync_engine_refill_session_inherits_solver_kw():
    """``SolverEngine.refill_session`` folds the engine's per-kind solver
    kwargs (deprecated spellings included) into the session."""
    with pytest.warns(DeprecationWarning, match="maxflow_kw"):
        eng = SolverEngine(maxflow_kw={"max_rounds": 32}, device=CPU)
    rng = np.random.default_rng(14)
    probs = [_grid(rng, 12, 12) for _ in range(2)]
    got = eng.refill_session("maxflow", shape=(12, 12), capacity=2).run(probs)
    assert all(not bool(got[i].converged) for i in range(2))
    want = _sync_chunks("maxflow", probs, 2,
                        solver_kw={"maxflow": {"max_rounds": 32}})
    for i in range(2):
        assert_same(got[i], want[i])


def test_async_engine_deprecated_shims_delegate():
    rng = np.random.default_rng(1)
    p, w = _grid(rng, 6, 6), rng.integers(0, 9, (4, 4))
    with pytest.warns(DeprecationWarning, match="maxflow_kw"):
        eng = AsyncSolverEngine(max_batch=2, max_delay_ms=LONG_DEADLINE_MS,
                                maxflow_kw={"backend": "xla"}, device=CPU)
    with eng:
        with pytest.warns(DeprecationWarning, match="submit_maxflow"):
            f0 = eng.submit_maxflow(p)
        with pytest.warns(DeprecationWarning, match="submit_assignment"):
            f1 = eng.submit_assignment(w)
        eng.flush_now()
        assert_same(f0.result(timeout=WAIT_S),
                    _sync_chunks("maxflow", [p], 1)[0])
        assert_same(f1.result(timeout=WAIT_S),
                    _sync_chunks("assignment", [w], 1)[0])


def test_refill_metrics_snapshot():
    m = SchedulerMetrics(ewma_alpha=1.0)
    snap = m.snapshot()["refill"]
    assert snap == {"sessions": {}, "admitted": {},
                    "slot_occupancy_ewma": {}, "utilization": None}
    m.record_refill_session("maxflow")
    m.record_refill_admit("maxflow", 3)
    m.record_refill_cycle("maxflow", 1.0)
    m.record_refill_cycle("maxflow", 0.5)
    snap = m.snapshot()["refill"]
    assert snap["sessions"] == {"maxflow": 1}
    assert snap["admitted"] == {"maxflow": 3}
    assert snap["slot_occupancy_ewma"]["maxflow"] == 0.5   # alpha=1: last
    assert snap["utilization"] == 0.75                     # mean of cycles


def _check_stream(seed):
    """One random ragged stream through ``AsyncSolverEngine(refill=True)``:
    random sizes, kinds and arrival order; every future must equal its
    per-request REFERENCE solve however the refill schedule fell."""
    rng = np.random.default_rng(seed)
    reqs = []                                    # (kind, payload, checker)
    for _ in range(int(rng.integers(6, 13))):
        k = int(rng.integers(3))
        if k == 0:
            h, w = int(rng.integers(4, 9)), int(rng.integers(4, 9))
            p = _grid(rng, h, w, easy=bool(rng.integers(2)))
            ref = _mf_ref(p)
            reqs.append(("maxflow", p,
                         lambda r, ref=ref: float(r.flow) == ref))
        elif k == 1:
            n = int(rng.integers(3, 7))
            w = rng.integers(0, 50, (n, n))
            ref = optimal_weight(w)
            reqs.append(("assignment", w,
                         lambda r, ref=ref: int(r.weight) == ref))
        else:
            nl, nr = int(rng.integers(3, 8)), int(rng.integers(3, 8))
            a = random_bipartite(rng, nl, nr, float(rng.uniform(0.1, 0.5)))
            ref = hopcroft_karp(a)[2]
            reqs.append(("matching", a,
                         lambda r, ref=ref: int(r.cardinality) == ref))
    with AsyncSolverEngine(max_batch=int(rng.integers(2, 5)),
                           max_delay_ms=float(rng.uniform(1.0, 20.0)),
                           refill=True, bucket="pow2",
                           n_lanes=int(rng.integers(1, 3)),
                           device=CPU) as eng:
        futs = [eng.submit(kind, payload) for kind, payload, _ in reqs]
        if rng.integers(2):
            eng.flush_now()
        results = [f.result(timeout=WAIT_S) for f in futs]
    for (kind, _, check), r in zip(reqs, results):
        assert check(r), f"{kind} result diverged from reference (seed " \
                         f"{seed})"


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_fixed_seed_ragged_streams_match_references(seed):
    """The reference's ragged-stream property at fixed seeds."""
    _check_stream(seed)


# ------------------------------------------------------- warm requests

@pytest.mark.parametrize("refill", [False, True])
def test_scheduler_submit_base_delta_warm_path(refill):
    """A warm request (``base=`` a solved ticket, ``delta=`` an edit)
    through the closed-batch and the continuous-batching route: the
    reference's warm flush of the same request, and the oracle."""
    rng = np.random.default_rng(12)
    p = _grid(rng, 5, 5)
    d = GraphDelta(idx=(np.array([3]), np.array([2]), np.array([2])),
                   values=np.array([9.0], np.float32), field="cap_nbr")
    p2 = apply_delta("maxflow", p, d)
    with AsyncSolverEngine(max_batch=4 if not refill else 2,
                           max_delay_ms=10.0, refill=refill,
                           device=CPU) as eng:
        r1 = eng.submit("maxflow", p).result(timeout=WAIT_S)
        assert float(r1.flow) == _mf_ref(p)
        r2 = eng.submit("maxflow", base=0, delta=d).result(timeout=WAIT_S)
    snap = eng.metrics.snapshot()["warm"]
    assert snap["cache_hits"] >= 1 and snap["warm_solves"] >= 1
    assert float(r2.flow) == _mf_ref(p2)
    jeng = jengine.SolverEngine()
    jt = jeng.submit("maxflow", _jax("maxflow", p))
    assert_same(r1, jeng.flush()[jt])
    jt = jeng.submit("maxflow", base=jt, delta=jwarm.GraphDelta(*d))
    assert_same(r2, jeng.flush()[jt])


# ------------------------------------------------------- matching kind

def test_async_scheduler_serves_matching():
    """Futures bit-match the sync flush of the same chunks: the matching
    kind rides the scheduler with zero scheduler changes."""
    rng = np.random.default_rng(12)
    adjs = [random_bipartite(rng, 8, 8) for _ in range(8)]
    with AsyncSolverEngine(max_batch=4, max_delay_ms=LONG_DEADLINE_MS,
                           device=CPU) as eng:
        futs = [eng.submit("matching", a) for a in adjs]
        res = [f.result(timeout=WAIT_S) for f in futs]
        assert eng.metrics.convergence.spread("matching") is not None
        snap = eng.metrics.snapshot()
    assert "matching" in snap["spread_ewma"]
    for got, want in zip(res, _sync_chunks("matching", adjs, 4)):
        assert_same(got, want)
