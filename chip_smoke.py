"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``src/repro_torch`` only (no ``jax``, nothing of ``repro``):

1. builds every kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   per source, all at once) and prints the card's name and power limit;
2. holds each kernel (K1 ``grid_push_decide``, K2
   ``grid_push_decide_sched``, K3 ``bfs_relabel_sweeps``) to its plain
   PyTorch version on random inputs at the main path's shapes
   (4 x 512^2), bit for bit, and times both with CUDA events;
3. drives the main path, ``maxflow_grid_batch`` on 4 seeded
   ``random_grid_problem`` instances of 512 x 512, with ``backend="pallas"``
   and ``backend="xla"``: both converge, match the scipy oracle, satisfy
   ``check_no_violations`` and agree on every leaf;
4. drives ``backend="balanced"`` on the same batch (oracle flows) and on
   ``checkerboard_problem(256, 256)`` (flow 256, 448 rounds, 12
   heuristics: the JAX package's counts);
5. reads the launch counts of each of the four solves of phases 3 and 4
   (``pallas``, ``xla``, balanced batch, balanced checkerboard; each set
   to 0 just before its solve and read just after) and fails if a kernel
   of that solve was never launched.

Prints one JSON line per kernel summary, the ``nvidia-smi`` name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Exits non-zero
without a CUDA device, and in a directory that holds nothing else of the
repository.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

B, H, W = 4, 512, 512          # the main path's batch
SEED = 0
# the balanced backend's worst case for the fixed cadence, and the JAX
# package's (flow, rounds, heuristics) on it
CHECKERBOARD = (256, 256)
CHECKERBOARD_WANT = (256.0, 448, 12)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM non-tensor 32-bit rate (data sheet)
KERNEL_SOURCES = {
    "grid_push_decide": ("src/repro_torch/kernels/csrc/grid_push.cu",
                         "src/repro/kernels/grid_push/kernel.py:116"),
    "grid_push_decide_sched": ("src/repro_torch/kernels/csrc/grid_push.cu",
                               "src/repro/kernels/grid_push/kernel.py:167"),
    "bfs_relabel_sweeps": ("src/repro_torch/kernels/csrc/bfs_relabel.cu",
                           "src/repro/kernels/bfs_relabel/kernel.py:94"),
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_events(prof):
    """``(self device us, count, name)`` of every device-side event of a
    ``torch.profiler`` run (kernels, memsets, copies), largest first. The
    host ops that launched them report the same time again, so they are
    left out."""
    from torch.autograd import DeviceType
    return sorted(((ev.self_device_time_total, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)


def time_ms(fn, reps: int = 50) -> tuple[float, float]:
    """``(device ms, loop ms)`` per call of ``fn()``, after a warm-up call.

    Device ms is the device time of every kernel that ``reps`` calls ran,
    from ``torch.profiler``, over ``reps``: the work on the card, without
    the host's launch overhead. Loop ms is CUDA events around a Python loop
    of ``reps`` calls, so it also holds the host's launch rate when that is
    slower than the card."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    loop_ms = start.elapsed_time(stop) / reps
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device_ms = sum(r[0] for r in device_events(prof)) / 1e3 / reps
    if device_ms <= 0:
        raise AssertionError("torch.profiler saw no device time")
    return device_ms, loop_ms


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """Least time (ms) for moving ``nbytes`` and doing ``nops`` ops."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bits(t: torch.Tensor) -> torch.Tensor:
    """Bit pattern of a 32-bit tensor (so -0.0 and 0.0 differ)."""
    return t.contiguous().view(torch.int32)


def compare(got, want, what: str) -> float:
    """Require bitwise equality; returns the max abs difference (0.0)."""
    err = 0.0
    for g, w in zip(got, want):
        if g is None and w is None:
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{what}: {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        err = max(err, (g.double() - w.double()).abs().max().item())
        if not torch.equal(bits(g), bits(w)):
            raise AssertionError(f"{what}: kernel != plain version "
                                 f"(max abs err {err})")
    return err


def random_state(rng, dev):
    """Random decision inputs at the main path's shapes: integer caps with
    zeros, half the nodes active, heights spread over [0, 2N)."""
    from repro_torch.core.maxflow.ref import random_grid_problem
    n_nodes = H * W + 2
    probs = [random_grid_problem(rng, H, W) for _ in range(B)]
    cap = np.stack([p[0] for p in probs], axis=1)
    cs = np.stack([p[1] for p in probs])
    ct = np.stack([p[2] for p in probs])
    e = rng.integers(0, 20, (B, H, W)) * (rng.random((B, H, W)) < 0.5)
    h = rng.integers(0, 2 * n_nodes, (B, H, W))
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=dev)  # noqa: E731
    return (t(e, torch.float32), t(h, torch.int32), t(cap, torch.float32),
            t(cs, torch.float32), t(ct, torch.float32), n_nodes)


def phase_kernels(dev, card: str) -> dict:
    """Each kernel against its plain version, bitwise, with timings."""
    from repro_torch.core.maxflow.grid import INF_H
    from repro_torch.kernels.bfs_relabel.kernel import (SWEEPS,
                                                        bfs_relabel_sweeps)
    from repro_torch.kernels.bfs_relabel.ref import bfs_relabel_sweeps_ref
    from repro_torch.kernels.grid_push.kernel import (grid_push_decide,
                                                      grid_push_decide_sched)
    from repro_torch.kernels.grid_push.ops import tile_schedule, tile_shape
    from repro_torch.kernels.grid_push.ref import (grid_push_decide_ref,
                                                   grid_push_decide_sched_ref)
    rng = np.random.default_rng(SEED)
    e, h, cap, cs, ct, n_nodes = random_state(rng, dev)
    nodes = B * H * W
    out = {}

    # K1: 32 B in (e, h, 4 caps, 2 terminal caps), 28 B out (h_new, 6
    # deltas) per node; about 30 compare/select/min ops per node.
    args = (e, h, cap, cs, ct, n_nodes)
    err = compare(grid_push_decide(*args), grid_push_decide_ref(*args), "K1")
    b_ms, b_by = bound(60 * nodes, 30 * nodes)
    out["grid_push_decide"] = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: grid_push_decide(*args),
                  lambda: grid_push_decide_ref(*args)))

    # K2: some tiles active, some not (whole 64x64 tiles of e zeroed).
    bh, bw = tile_shape(H, W)
    keep = torch.tensor(rng.random((B, H // bh, W // bw)) < 0.5, device=dev)
    keep = keep.repeat_interleave(bh, 1).repeat_interleave(bw, 2)
    e2 = torch.where(keep, e, torch.zeros_like(e))
    sched, n_act = tile_schedule(e2 > 0, bh, bw)
    args2 = (e2, h, cap, cs, ct, sched, n_act, n_nodes)
    kw = dict(block_h=bh, block_w=bw)
    got = grid_push_decide_sched(*args2, **kw)
    err = compare(got, grid_push_decide_sched_ref(*args2, bh, bw), "K2")
    compare(got, grid_push_decide(e2, h, cap, cs, ct, n_nodes), "K2 vs K1")
    active_nodes = int(n_act.sum()) * bh * bw
    # decided tiles move K1's 60 B per node; identity tiles read h and
    # write h_new and 6 zero deltas (32 B); plus the schedule itself
    b_ms, b_by = bound(60 * active_nodes + 32 * (nodes - active_nodes)
                       + 4 * (sched.numel() + n_act.numel()),
                       30 * active_nodes)
    out["grid_push_decide_sched"] = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        active_tiles=int(n_act.sum()), tiles=int(sched.numel()),
        **timings(lambda: grid_push_decide_sched(*args2, **kw),
                  lambda: grid_push_decide_sched_ref(*args2, bh, bw)))

    # K3: both planes from their seeds, SWEEPS sweeps; the sink-only form
    # with an odd sweep count (the other ping-pong buffer) too.
    seed_t = torch.where(ct > 0, 1, INF_H).to(torch.int32)
    seed_s = torch.where(cs > 0, n_nodes + 1, INF_H).to(torch.int32)
    args3 = (cap, seed_t, seed_s, seed_t, seed_s)
    err = compare(bfs_relabel_sweeps(*args3),
                  bfs_relabel_sweeps_ref(*args3, sweeps=SWEEPS), "K3")
    compare(bfs_relabel_sweeps(cap, seed_t, None, seed_t, None, sweeps=3),
            bfs_relabel_sweeps_ref(cap, seed_t, None, seed_t, None, sweeps=3),
            "K3 sink-only")
    # per call: 4 caps, 2 seeds, 2 planes in and 2 planes out, 40 B per
    # node; per node, sweep and plane about 18 ops (4 x load/compare/add/
    # min, seed min)
    b_ms, b_by = bound(40 * nodes, 18 * 2 * SWEEPS * nodes)
    out["bfs_relabel_sweeps"] = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        sweeps_per_call=SWEEPS,
        **timings(lambda: bfs_relabel_sweeps(*args3),
                  lambda: bfs_relabel_sweeps_ref(*args3, sweeps=SWEEPS)))
    for name, row in out.items():
        log(f"[kernels] {name}: equal to plain, device {row['ms']:.4f} ms "
            f"(loop {row['loop_ms']:.4f} ms; plain device "
            f"{row['plain_ms']:.4f} ms, loop {row['plain_loop_ms']:.4f} ms; "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}) on {card}")
    return out


def timings(kernel, plain) -> dict:
    """Device and loop ms per call of a kernel's wrapper and its plain
    version (see ``time_ms``)."""
    ms, loop_ms = time_ms(kernel)
    plain_ms, plain_loop_ms = time_ms(plain)
    return dict(ms=ms, plain_ms=plain_ms, loop_ms=loop_ms,
                plain_loop_ms=plain_loop_ms)


def counters():
    from repro_torch.kernels.bfs_relabel.kernel import bfs_relabel_sweeps
    from repro_torch.kernels.grid_push.kernel import (grid_push_decide,
                                                      grid_push_decide_sched)
    return {f.__name__: f for f in (grid_push_decide, grid_push_decide_sched,
                                    bfs_relabel_sweeps)}


def reset_counts():
    for f in counters().values():
        f.launches = 0


def read_counts() -> dict:
    return {name: f.launches for name, f in counters().items()}


def require_launched(counts: dict, names, phase: str):
    for name in names:
        if counts[name] <= 0:
            raise AssertionError(f"{phase}: {name} was never launched")


def solve(fn, *a, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn(*a, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def profile(what: str, wall: float, fn, *a, **kw):
    """One more run of ``fn`` under ``torch.profiler``: device busy time
    (the sum of every device op's own time) and the ops that take most of
    it. The idle share divides busy by ``wall``, the unprofiled solve's
    time, since the profiler slows the host. Outside the counted runs."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       acc_events=True) as prof:
        _, secs = solve(fn, *a, **kw)
    rows = device_events(prof)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"[profile] {what}: wall {wall:.4f} s unprofiled ({secs:.4f} s "
        f"profiled), device busy {busy:.4f} s, idle share "
        f"{1 - busy / wall:.3f}")
    for us, count, key in rows[:8]:
        log(f"[profile]   {us / 1e3:9.3f} ms  {count:6d} x  {key[:90]}")


def check_oracle(res, oracle, what: str, invariant: bool = True):
    """Converged, oracle flows and (fixed cadence) no violating edge. The
    balanced backend's bidirectional relabel can leave an edge from a
    source-reachable node into a doubly unreached one violating the
    invariant at the end of a solve, in the reference as in the port, so
    it is not checked there."""
    from repro_torch.core.maxflow.grid import check_no_violations
    if not bool(res.converged.all()):
        raise AssertionError(f"{what}: not converged")
    flows = res.flow.reshape(-1).tolist()
    if flows != [float(f) for f in oracle]:
        raise AssertionError(f"{what}: flows {flows} != oracle {oracle}")
    if invariant and not bool(check_no_violations(res.state).all()):
        raise AssertionError(f"{what}: height invariant violated")


def phase_main(dev, problems, oracle, counts: dict):
    """Fixed cadence: pallas and xla on the batch, every leaf equal."""
    from repro_torch.core.maxflow.grid import GridProblem, maxflow_grid_batch
    from repro_torch.interop import to_numpy
    prob = GridProblem(*(np.stack([p[k] for p in problems]) for k in range(3)))
    results, walls = {}, {}
    for backend in ("pallas", "xla"):
        reset_counts()
        res, walls[backend] = solve(maxflow_grid_batch, prob,
                                    backend=backend, device=dev)
        counts[backend] = read_counts()
        check_oracle(res, oracle, backend)
        results[backend] = to_numpy(res)
        log(f"[main] backend={backend}: flows {res.flow.tolist()}, rounds "
            f"{res.rounds.tolist()}, heuristics {res.heuristics.tolist()}, "
            f"{walls[backend]:.4f} s, launches {counts[backend]}")
    require_launched(counts["pallas"], ["grid_push_decide",
                                        "bfs_relabel_sweeps"], "pallas")
    require_launched(counts["xla"], ["bfs_relabel_sweeps"], "xla")
    for backend in ("pallas", "xla"):
        profile(f"backend={backend} batch", walls[backend],
                maxflow_grid_batch, prob, backend=backend, device=dev)
    a, b = results["pallas"], results["xla"]
    for key in ("flow", "cut", "rounds", "heuristics", "converged"):
        if not np.array_equal(a[key], b[key]):
            raise AssertionError(f"pallas and xla differ in {key}")
    for key, v in a["state"].items():
        if not np.array_equal(v, b["state"][key]):
            raise AssertionError(f"pallas and xla differ in state.{key}")
    return prob


def phase_balanced(dev, prob, oracle, counts: dict):
    """Balanced backend: the batch against the oracle, then the
    checkerboard against the JAX package's counts. Each of the two solves
    has its own launch counts."""
    from repro_torch.core.maxflow.grid import (GridProblem, maxflow_grid,
                                               maxflow_grid_batch)
    from repro_torch.core.maxflow.ref import checkerboard_problem
    balanced = ["grid_push_decide_sched", "bfs_relabel_sweeps"]
    reset_counts()
    res, batch_wall = solve(maxflow_grid_batch, prob, backend="balanced",
                            device=dev)
    counts["balanced_batch"] = read_counts()
    check_oracle(res, oracle, "balanced", invariant=False)
    log(f"[balanced] batch: flows {res.flow.tolist()}, rounds "
        f"{res.rounds.tolist()}, heuristics {res.heuristics.tolist()}, "
        f"{batch_wall:.4f} s, launches {counts['balanced_batch']}")
    require_launched(counts["balanced_batch"], balanced, "balanced batch")

    board = GridProblem(*checkerboard_problem(*CHECKERBOARD))
    reset_counts()
    res, board_wall = solve(maxflow_grid, board, backend="balanced",
                            max_rounds=500_000, device=dev)
    counts["balanced_checkerboard"] = read_counts()
    got = (float(res.flow), int(res.rounds), int(res.heuristics))
    log(f"[balanced] checkerboard {CHECKERBOARD}: flow, rounds, heuristics "
        f"= {got}, {board_wall:.4f} s, launches "
        f"{counts['balanced_checkerboard']}")
    if got != CHECKERBOARD_WANT or not bool(res.converged):
        raise AssertionError(f"checkerboard {CHECKERBOARD}: {got} != "
                             f"{CHECKERBOARD_WANT}")
    require_launched(counts["balanced_checkerboard"], balanced,
                     "balanced checkerboard")
    profile("backend=balanced batch", batch_wall, maxflow_grid_batch, prob,
            backend="balanced", device=dev)
    profile(f"backend=balanced checkerboard {CHECKERBOARD}", board_wall,
            maxflow_grid, board, backend="balanced", max_rounds=500_000,
            device=dev)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs only on the card")
        return 1
    from repro_torch.core.maxflow.ref import (maxflow_grid_ref,
                                              random_grid_problem)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[build] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    for name, report in _build.build_all().items():
        log(f"[build] {name}.cu:\n{report.strip()}")
    log(f"[build] done in {time.perf_counter() - t0:.1f} s")

    kernels = phase_kernels(dev, card)

    rng = np.random.default_rng(SEED)
    problems = [random_grid_problem(rng, H, W) for _ in range(B)]
    oracle = [maxflow_grid_ref(*p) for p in problems]
    log(f"[main] scipy oracle flows {oracle}")
    counts = {}
    prob = phase_main(dev, problems, oracle, counts)
    phase_balanced(dev, prob, oracle, counts)

    # max_abs_err, ms, plain_ms, bound_ms, bound_by (+ details) come from
    # phase_kernels; launches are summed over the four solves; no single
    # PyTorch call computes these functions
    rows = [dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=sum(c[name] for c in counts.values()),
                 library_ms=None, equal=True, card=card, **kernels[name])
            for name, (source, replaces) in KERNEL_SOURCES.items()]
    log(f"[done] launches per phase {counts}; "
        f"{time.perf_counter() - t0:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
