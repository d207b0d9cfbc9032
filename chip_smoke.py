"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``src/repro_torch`` only (no ``jax``, nothing of ``repro``):

1. builds every kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   per source, all at once) and prints the card's name and power limit;
2. holds each kernel to its plain PyTorch version, bit for bit, and times
   both (``torch.profiler`` device time over 50 calls): K1
   ``grid_push_decide``, K2 ``grid_push_decide_sched`` and K3
   ``bfs_relabel_sweeps`` at the grid path's shapes (4 x 512^2; K2 and K3
   also at the checkerboard's 1 x 256^2, K3 from the seeds and from
   mid-fixpoint planes, for 1, 3, 8 and 20 sweeps, with ``ds`` on and off,
   and over every tile shape it may be launched with), K4
   ``bidding`` at the assignment path's (8 x 512^2, with ``torch.topk``
   as its one-call yardstick) and K5 ``frontier`` at the matching path's
   (4 x 4096^2, with ``torch.min`` over a packed key as its yardstick);
   K6 ``flash_attention_fwd`` within 3e-5 (float32) and 2e-2 (bfloat16)
   of its plain version over the JAX kernel test's sweep, tails and head
   widths off its tiles (``FLASH_TAILS``) and at the serve path's prefill
   shape (8 x 1024 tokens, 9 heads over 3 kv heads, dh 64, causal, float32
   and bfloat16), with ``F.scaled_dot_product_attention`` timed as its
   yardstick; K4 and K5 are timed once more with the L2 flushed before
   every call, and K5 also at 3% and 95% of its rows labeled (``[k5]``
   lines: each time against its bound);
3. drives the grid path, ``maxflow_grid_batch`` on 4 seeded
   ``random_grid_problem`` instances of 512 x 512, with ``backend="pallas"``
   and ``backend="xla"``: both converge, match the scipy oracle, satisfy
   ``check_no_violations`` and agree on every leaf;
4. drives ``backend="balanced"`` on the same batch (oracle flows) and on
   ``checkerboard_problem(256, 256)`` (flow 256, 448 rounds, 12
   heuristics: the JAX package's counts);
5. drives the assignment path, ``solve_assignment`` on 8 x 512^2 seeded
   weights in [0, 100], for ``method="auction"`` and ``"pushrelabel"``
   on ``backend="pallas"`` and ``"xla"``: scipy's optimal weights, the
   JAX package's rounds, the backends equal on every leaf; every K4
   launch on its vector path, and K4's time per launch in each profiled
   ``pallas`` solve against its bound (``[k4]`` lines, ``in_solve`` of
   the ``bidding`` row);
6. drives the matching path, ``match_bipartite_batch`` on 4 seeded
   4096 x 4096 graphs at p = 4/n on both backends: Hopcroft-Karp's
   cardinalities, the JAX package's phases, the backends equal; K5 runs
   once per frontier sweep, 150 launches and 150 ``frontier_`` kernels in
   the profiled ``pallas`` solve, and one more ``pallas`` solve with a
   hook on ``core.matching.bfs._expand`` counts the labeled rows K5 reads
   (1,436,825; a ``[k5]`` line holds them against K5's time in the solve);
7. drives the LLM serving path, smollm-135m at full width (30 layers) on
   weights from ``repro_torch.interop.numpy_params`` (seed 0): 8 prompts
   of 1024 tokens and 16 new tokens through ``make_prefill_step`` and
   ``make_serve_step``, a warm-up and two timed runs. Each run's tokens and
   logits are held to the JAX package's top-5 per step and request
   (``tests/torch_smoke_serve.json``, see ``check_serve``); K6 must launch
   once per layer in each prefill, every launch of the profiled prefill on
   the wgmma kernel ``flash_fwd_wgmma``, and never in a decode step.
   Matmuls stay in full float32 (``torch.backends.cuda.matmul.allow_tf32``
   is False);
8. reads the launch counts of every solve of phases 3 to 7 (each set to 0
   just before its solve and read just after) and fails if a kernel of
   that solve was never launched, or if K4 or K5 was launched by an
   ``xla`` solve. K3 counts launches (one per call of up to 8 sweeps) and
   sweeps; each grid solve logs both, and K3's device time per launch
   inside the profiled solve against its bound per call.

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
from typing import NamedTuple

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
# cost-scaling assignment: B x n x n weights in [0, 100] (the paper's cost
# range, section 6), and matching: B Erdos-Renyi n x n graphs at p = 4 / n
ASSIGN_B, ASSIGN_N = 8, 512
MATCH_B, MATCH_N = 4, 4096
# the JAX package's rounds (assignment, per method) and phases (matching)
# per instance on those batches, from a CPU run of
# `PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_smoke_constants.py`
ASSIGN_ROUNDS_WANT = {
    "auction": (320, 384, 352, 368, 336, 384, 368, 352),
    "pushrelabel": (720, 816, 752, 752, 800, 800, 800, 784)}
MATCH_ROUNDS_WANT = (8, 10, 8, 7)
# the serve path: the model, batch, prompt length and new tokens; the JAX
# package's top-5 logits per step on the same weights and prompts, from a
# CPU run of `PYTHONPATH=src JAX_PLATFORMS=cpu python
# tests/torch_smoke_constants.py serve`
SERVE_ARCH = "smollm-135m"
SERVE_B, SERVE_S, SERVE_NEW = 8, 1024, 16
SERVE_CONSTANTS = ROOT / "tests" / "torch_smoke_serve.json"
# Each of the port's logits at JAX's top-5 ids must lie within LOGIT_TOL x
# the step's largest |logit| (JAX's, per request) of JAX's value. Both run
# in float32 (no TF32) and differ only in summation order (cuBLAS and K6
# against XLA on the CPU); at smoke size on the CPU that difference is
# about 1e-6 of the largest logit, and 1e-3 leaves room for 30 layers and
# 1024 positions while a kernel that drops a key tile or reads the wrong
# kv head moves the logits far more (phase 2 holds K6 itself to 3e-5).
LOGIT_TOL = 1e-3
# K6 against its plain version: (B, Sq, Sk, H, KV, dh, dv), causal, dtype
# -- the JAX kernel test's sweep (dh != dv, MQA, non-causal) and its
# bfloat16 case; the serve path's shape is added from SERVE_* in phase 2
FLASH_SWEEP = [
    ((2, 64, 64, 4, 2, 16, 16), True, torch.float32),
    ((1, 128, 128, 6, 3, 32, 16), False, torch.float32),
    ((2, 256, 256, 8, 8, 64, 64), True, torch.float32),
    ((1, 64, 64, 4, 1, 16, 8), True, torch.float32),
    ((1, 512, 512, 2, 2, 32, 32), True, torch.float32),
    ((2, 64, 64, 4, 2, 16, 16), True, torch.bfloat16),
]
FLASH_TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
# K6 in float32 and bfloat16, besides the serve shape: (B, Sq, Sk, H, KV,
# dh, dv), causal, dtype -- Sq and Sk off the 64-row query and 64/32-key
# tiles, Sq != Sk both ways, MQA, every head-width class
FLASH_TAILS = [
    ((1, 100, 1000, 4, 1, 64, 64), False, torch.float32),
    ((1, 1000, 100, 4, 2, 64, 64), True, torch.float32),
    ((2, 77, 77, 4, 2, 8, 8), True, torch.float32),
    ((1, 100, 100, 4, 2, 24, 24), False, torch.float32),
    ((1, 100, 100, 4, 2, 72, 72), True, torch.float32),
    ((1, 129, 129, 4, 2, 192, 128), False, torch.float32),
    ((1, 100, 100, 2, 2, 256, 256), True, torch.float32),
    ((1, 100, 1000, 4, 1, 72, 40), False, torch.bfloat16),
    ((1, 65, 65, 2, 1, 256, 256), True, torch.bfloat16),
]
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM non-tensor 32-bit rate (data sheet)
# H100 SXM dense tensor-core rates (data sheet): K6 runs a float32 product
# as three TF32 products, a bfloat16 one as one bf16 product
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
L2_FLUSH_BYTES = 128 << 20     # written between calls to time K4, K5 L2-cold
# K5's shares of labeled rows, timed on their own (half first: the row's
# main input); a matching solve's sweeps run from 2% to 96%
K5_SHARES = (0.5, 0.03, 0.95)
# K5 launches and labeled-row reads (rows with root < INF, summed over the
# batch and the calls) in one matching pallas solve of the smoke's graphs;
# they do not depend on the machine (a CPU count with the hook of
# ``k5_reads``), so any other count means the solve changed
K5_READS_WANT = (150, 1_436_825)
KERNEL_SOURCES = {
    "grid_push_decide": ("src/repro_torch/kernels/csrc/grid_push.cu",
                         "src/repro/kernels/grid_push/kernel.py:116"),
    "grid_push_decide_sched": ("src/repro_torch/kernels/csrc/grid_push.cu",
                               "src/repro/kernels/grid_push/kernel.py:167"),
    "bfs_relabel_sweeps": ("src/repro_torch/kernels/csrc/bfs_relabel.cu",
                           "src/repro/kernels/bfs_relabel/kernel.py:94"),
    "bidding": ("src/repro_torch/kernels/csrc/bidding.cu",
                "src/repro/kernels/bidding/kernel.py:67"),
    "frontier": ("src/repro_torch/kernels/csrc/frontier.cu",
                 "src/repro/kernels/frontier/kernel.py:71"),
    "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:81"),
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


K3_SWEEPS = "bfs_relabel_sweeps.sweeps"   # K3's sweep count in read_counts
# what the port's kernels are called in a profile (csrc/*.cu)
PORT_KERNEL_SYMBOLS = tuple(
    f"{p}(anonymous namespace)::{k}" for p in ("", "void ")
    for k in ("grid_push_decide", "bfs_relabel_sweep", "bidding_kernel",
              "frontier_", "flash_fwd_"))


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


class Timing(NamedTuple):
    """One timing of ``time_ms`` or ``time_cold_ms``."""
    ms: float        # device ms per call
    loop_ms: float | None  # CUDA events around the loop, per call
    source: str      # where ``ms`` came from: "profiler", "loop", "events"


def profiled_ms(run, reps: int, symbol: str | None = None,
                only_symbol: bool = False) -> float | None:
    """Device ms per call of ``run(i)``, ``i`` in ``range(reps)``, from
    ``torch.profiler``: the self device time of every device event (only
    of kernels whose name holds ``symbol`` with ``only_symbol``) over
    ``reps``. Now and then, after many profiled runs in one process, a
    run records no device event at all, or a third of a kernel's
    launches, or misses one launch of a window; so a run counts only when
    every kind of event it times was seen at least 0.9 ``reps`` times,
    kernels holding ``symbol`` among them. Up to three runs; None when
    none counted."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    for _ in range(3):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA],
                           acc_events=True) as prof:
            for i in range(reps):
                run(i)
            torch.cuda.synchronize()
        rows = [r for r in device_events(prof)
                if not only_symbol or symbol in r[2]]
        if (rows and all(r[1] >= 0.9 * reps for r in rows)
                and (symbol is None or any(symbol in r[2] for r in rows))):
            return sum(r[0] for r in rows) / 1e3 / reps
    return None


def time_ms(fn, reps: int = 50, symbol: str | None = None) -> Timing:
    """Device and loop ms per call of ``fn()``, after a warm-up call.

    Device ms is the device time of every kernel that ``reps`` calls ran
    (``profiled_ms``; ``symbol`` names the kernel a wrapper launches): the
    work on the card, without the host's launch overhead. Loop ms is CUDA
    events around a Python loop of ``reps`` calls, so it also holds the
    host's launch rate when that is slower than the card. When no profiler
    run counts, device ms is the loop ms, an upper bound: ``source``
    says "loop" and a line says so."""
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
    ms = profiled_ms(lambda i: fn(), reps, symbol)
    if ms is not None:
        return Timing(ms, loop_ms, "profiler")
    log(f"[time] no torch.profiler run saw every device event for 0.9 "
        f"of the calls: device ms is the loop's {loop_ms:.4f} ms")
    return Timing(loop_ms, loop_ms, "loop")


def time_cold_ms(fn, symbol: str, reps: int = 50) -> Timing:
    """Device ms per call of ``fn()`` with a cold L2: ``L2_FLUSH_BYTES``
    are written before every call, and only the device time of kernels
    whose name holds ``symbol`` is counted (not the flush). When no
    profiled run counts (see ``profiled_ms``), CUDA events around each
    call give the time: ``source`` says "events" and a line says so."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def run(i):
        flush.fill_(i & 255)
        fn()
    run(0)
    torch.cuda.synchronize()
    ms = profiled_ms(run, reps, symbol, only_symbol=True)
    if ms is not None:
        return Timing(ms, None, "profiler")
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for i, (start, stop) in enumerate(marks):
        flush.fill_(i & 255)
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    ms = sum(a.elapsed_time(b) for a, b in marks) / reps
    log(f"[time] no torch.profiler run saw {symbol} kernels for 0.9 of "
        f"the calls: {ms:.4f} ms from CUDA events around each call")
    return Timing(ms, None, "events")


def took(row: dict, key: str, t: Timing) -> float:
    """``t.ms``, with its source noted as ``row["ms_from"][key]``."""
    row.setdefault("ms_from", {})[key] = t.source
    return t.ms


def bound(nbytes: float, nops: float,
          ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """Least time (ms) for moving ``nbytes`` and doing ``nops`` ops at
    ``ops_per_s``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
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


def random_state(rng, dev, shape=None):
    """Random decision inputs at ``shape`` (b, h, w), by default the main
    path's (B, H, W): integer caps with zeros, half the nodes active,
    heights spread over [0, 2N)."""
    from repro_torch.core.maxflow.ref import random_grid_problem
    nb, nh, nw = shape or (B, H, W)
    n_nodes = nh * nw + 2
    probs = [random_grid_problem(rng, nh, nw) for _ in range(nb)]
    cap = np.stack([p[0] for p in probs], axis=1)
    cs = np.stack([p[1] for p in probs])
    ct = np.stack([p[2] for p in probs])
    e = rng.integers(0, 20, (nb, nh, nw)) * (rng.random((nb, nh, nw)) < 0.5)
    h = rng.integers(0, 2 * n_nodes, (nb, nh, nw))
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=dev)  # noqa: E731
    return (t(e, torch.float32), t(h, torch.int32), t(cap, torch.float32),
            t(cs, torch.float32), t(ct, torch.float32), n_nodes)


def assignment_weights() -> np.ndarray:
    """The assignment phase's ``(ASSIGN_B, n, n)`` int64 weights."""
    return np.random.default_rng(SEED).integers(
        0, 101, size=(ASSIGN_B, ASSIGN_N, ASSIGN_N))


def matching_adjacency() -> np.ndarray:
    """The matching phase's ``(MATCH_B, n, n)`` bool adjacencies."""
    from repro_torch.core.matching.ref import random_bipartite
    rng = np.random.default_rng(SEED)
    return np.stack([random_bipartite(rng, MATCH_N, MATCH_N, 4 / MATCH_N)
                     for _ in range(MATCH_B)])


def phase_kernels(dev, card: str) -> dict:
    """Each kernel against its plain version, bitwise (K6 within its
    tolerance), with timings."""
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
                  lambda: grid_push_decide_ref(*args), "grid_push_decide"))

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
    # 256^2 alone (B = 1), as the checkerboard solve launches it: 16 tiles
    # of 64 x 64, some idle
    board_args, board_kw = k2_board_args(rng, dev)
    compare(grid_push_decide_sched(*board_args, **board_kw),
            grid_push_decide_sched_ref(*board_args, *board_kw.values()),
            "K2 256^2")
    compare(grid_push_decide_sched(*board_args, **board_kw),
            grid_push_decide(*board_args[:5], board_args[-1]),
            "K2 256^2 vs K1")
    active_nodes = int(n_act.sum()) * bh * bw
    # decided tiles move K1's 60 B per node; identity tiles read h and
    # write h_new and 6 zero deltas (32 B); plus the schedule itself
    b_ms, b_by = bound(60 * active_nodes + 32 * (nodes - active_nodes)
                       + 4 * (sched.numel() + n_act.numel()),
                       30 * active_nodes)
    row = out["grid_push_decide_sched"] = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        active_tiles=int(n_act.sum()), tiles=int(sched.numel()),
        **timings(lambda: grid_push_decide_sched(*args2, **kw),
                  lambda: grid_push_decide_sched_ref(*args2, bh, bw),
                  "grid_push_decide"))
    row["board_ms"] = took(row, "board_ms", time_ms(
        lambda: grid_push_decide_sched(*board_args, **board_kw),
        symbol="grid_push_decide"))
    # grid_push.cu's launch: one block per 256-node chunk of every tile of
    # every instance (the formula, not a reading of the launch)
    log(f"[kernels] K2 launch by grid_push.cu's formula: "
        f"{int(sched.numel()) * -(-bh * bw // 256)} blocks of 256 threads "
        f"at {B} x {H} x {W}, {-(-bh * bw // 256) * board_args[5].numel()} "
        f"at 1 x {CHECKERBOARD[0]} x {CHECKERBOARD[1]}")

    out["bfs_relabel_sweeps"] = kernels_k3(dev, cap, cs, ct, n_nodes)
    for row in out.values():
        row["library_ms"] = None   # no single PyTorch call computes K1-K3
    out.update(kernels_assignment_matching(dev))
    out.update(kernels_flash(dev))
    for name, row in out.items():
        lib = row["library_ms"]
        how = ("equal to" if row.get("equal", True)
               else f"within {row['tolerance']} of")
        log(f"[kernels] {name}: {how} plain, device {row['ms']:.4f} ms "
            f"(loop {row['loop_ms']:.4f} ms; plain device "
            f"{row['plain_ms']:.4f} ms, loop {row['plain_loop_ms']:.4f} ms; "
            f"library {'none' if lib is None else f'{lib:.4f} ms'}; "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}) on {card}")
    return out


def k2_board_args(rng, dev):
    """K2's inputs at the checkerboard solve's shape, 1 x 256^2, with every
    other 64 x 64 tile idle."""
    from repro_torch.kernels.grid_push.ops import tile_schedule, tile_shape
    e, h, cap, cs, ct, n_nodes = random_state(rng, dev,
                                              (1, *CHECKERBOARD))
    bh, bw = tile_shape(*CHECKERBOARD)
    e.view(1, -1, bh, CHECKERBOARD[1] // bw, bw)[:, ::2, :, 1::2] = 0
    sched, n_act = tile_schedule(e > 0, bh, bw)
    return ((e, h, cap, cs, ct, sched, n_act, n_nodes),
            dict(block_h=bh, block_w=bw))


def k3_planes(cap, cs, ct, n_nodes, calls: int):
    """K3's seeds and the planes after ``calls`` plain calls of SWEEPS
    sweeps from them (so wavefronts cross tile edges in the next call)."""
    from repro_torch.core.maxflow.grid import INF_H
    from repro_torch.kernels.bfs_relabel.kernel import SWEEPS
    from repro_torch.kernels.bfs_relabel.ref import bfs_relabel_sweeps_ref
    seed_t = torch.where(ct > 0, 1, INF_H).to(torch.int32)
    seed_s = torch.where(cs > 0, n_nodes + 1, INF_H).to(torch.int32)
    dt, ds = seed_t, seed_s
    for _ in range(calls):
        dt, ds, _ = bfs_relabel_sweeps_ref(cap, seed_t, seed_s, dt, ds,
                                           sweeps=SWEEPS)
    return seed_t, seed_s, dt, ds


def k3_bound(nodes: int, with_ds: bool) -> tuple[float, str]:
    """K3's bound per call of SWEEPS sweeps: caps, seeds and planes read
    once, planes written once, 40 B per node (28 B with ds off); the
    sweeps' integer work, about 18 ops per node, sweep and plane."""
    from repro_torch.kernels.bfs_relabel.kernel import SWEEPS
    planes = 2 if with_ds else 1
    return bound((12 * planes + 16) * nodes, 18 * planes * SWEEPS * nodes)


def kernels_k3(dev, cap, cs, ct, n_nodes) -> dict:
    """K3 against its plain version, bitwise (planes and ``changed``), at
    the grid path's 4 x 512^2 and at the checkerboard's 1 x 256^2: from the
    seeds, from mid-fixpoint planes, for 1, 3, SWEEPS and 20 sweeps (20
    takes three launches), with ds on and off; then every tile shape of
    ``TILES`` at both shapes. Times the SWEEPS-sweep call with both planes
    from the seeds (the balanced relabel's first call) and the tile
    shapes."""
    from repro_torch.core.maxflow.ref import checkerboard_problem
    from repro_torch.kernels.bfs_relabel.kernel import (
        SWEEPS, TILES, _sweeps, bfs_relabel_sweeps, launch_geometry)
    from repro_torch.kernels.bfs_relabel.ref import bfs_relabel_sweeps_ref

    def check(args, sweeps, what, tiles=None):
        return compare(_sweeps(*args, sweeps, tiles),
                       bfs_relabel_sweeps_ref(*args, sweeps=sweeps), what)

    bc, bs, bt = (torch.tensor(a, device=dev).unsqueeze(a.ndim - 2)
                  for a in checkerboard_problem(*CHECKERBOARD))
    shapes = {"batch": (cap, cs, ct, n_nodes),
              "board": (bc, bs, bt, CHECKERBOARD[0] * CHECKERBOARD[1] + 2)}
    err, inputs = 0.0, {}
    for name, (c, s_, t_, n) in shapes.items():
        for calls in (0, 3):
            seed_t, seed_s, dt, ds = k3_planes(c, s_, t_, n, calls)
            for sweeps in (1, 3, SWEEPS, 20):
                what = f"K3 {name} after {calls} calls, {sweeps} sweeps"
                err = max(err, check((c, seed_t, seed_s, dt, ds), sweeps,
                                     what))
                check((c, seed_t, None, dt, None), sweeps, what + " ds off")
        inputs[name] = (c,) + k3_planes(c, s_, t_, n, 0)[:2] * 2
    args3 = inputs["batch"]
    row = timings(lambda: bfs_relabel_sweeps(*args3),
                  lambda: bfs_relabel_sweeps_ref(*args3, sweeps=SWEEPS),
                  "bfs_relabel_sweep")
    tiles_ms = {}
    for tiles in TILES:
        key = "{}x{}".format(*tiles)
        tiles_ms[key] = {}
        for name, args in inputs.items():
            check(args, SWEEPS, f"K3 {name} tiles {key}", tiles)
            tiles_ms[key][name] = took(
                row, f"tiles_ms.{key}.{name}",
                time_ms(lambda: _sweeps(*args, SWEEPS, tiles),
                        symbol="bfs_relabel_sweep"))
        log(f"[kernels] K3 tiles {key}: batch {tiles_ms[key]['batch']:.4f} "
            f"ms, board {tiles_ms[key]['board']:.4f} ms")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, args in inputs.items():
        log(f"[kernels] K3 {name} launch as launch_geometry picks it: "
            f"{launch_geometry(*args[1].shape, SWEEPS, True, n_sm)}")
    b_ms, b_by = k3_bound(cap[0].numel(), True)
    board_ms = took(row, "board_ms",
                    time_ms(lambda: bfs_relabel_sweeps(*inputs["board"]),
                            symbol="bfs_relabel_sweep"))
    board_bound = k3_bound(bc[0].numel(), True)[0]
    log(f"[kernels] K3 board: device {board_ms:.4f} ms against its bound "
        f"{board_bound:.4f} ms ({board_ms / board_bound:.2f}x)")
    return dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                sweeps_per_call=SWEEPS, tiles_ms=tiles_ms,
                board_ms=board_ms, **row)


def k4_k5_inputs(dev):
    """K4's and K5's inputs at the assignment and matching phases' shapes,
    from one generator, K4's draws first: ``(c, p_y, mask)`` and
    ``{share: (adj, root_row, match_row)}`` over ``K5_SHARES``.

    K4: the assignment phase's scaled costs, random prices, a fifth of the
    arcs masked (fixed or matched) and every 64th row fully masked. K5:
    the matching phase's graphs with ``share`` of the rows labeled (a
    solve's sweeps run from 2% to 96%), roots drawn from the rows, random
    matched columns; half labeled, the row's main input, is drawn first
    (the input of every earlier reading)."""
    from repro_torch.kernels.frontier.ref import INF
    rng = np.random.default_rng(SEED + 1)
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=dev)  # noqa: E731
    B, n = ASSIGN_B, ASSIGN_N
    c = t(-(n + 1) * assignment_weights(), torch.int32)
    p_y = t(rng.integers(-(n + 1) * 100, 1, (B, n)), torch.int32)
    m = rng.random((B, n, n)) < 0.2
    m[:, ::64] = True
    B, n = MATCH_B, MATCH_N
    adj = t(matching_adjacency(), torch.bool)
    k5 = {}
    for share in K5_SHARES:
        labeled = rng.random((B, n)) < share
        root = t(np.where(labeled, rng.integers(0, n, (B, n)), INF),
                 torch.int32)
        k5[share] = (adj, root, t(rng.integers(-1, n, (B, n)), torch.int32))
    return (c, p_y, t(m, torch.bool)), k5


def kernels_assignment_matching(dev) -> dict:
    """K4 and K5 against their plain versions at the assignment and
    matching phases' shapes (``k4_k5_inputs``), bitwise, with timings,
    L2-warm and L2-cold (K5 at each share of labeled rows), and the
    one-call PyTorch yardstick of each (``library_ms``, timed only)."""
    from repro_torch.kernels.bidding.kernel import bidding
    from repro_torch.kernels.bidding.ref import INF, bidding_ref
    from repro_torch.kernels.frontier.kernel import (
        frontier, launch_geometry, max_active_clusters)
    from repro_torch.kernels.frontier.ref import frontier_ref
    out = {}
    args, inputs = k4_k5_inputs(dev)
    c, p_y, mask = args
    B, n = ASSIGN_B, ASSIGN_N
    k4_geometry(args)
    err = compare(bidding(*args), bidding_ref(*args), "K4")
    masked = torch.where(mask, INF, c - p_y[:, None, :])
    b_ms, b_by = k4_bound()
    row = out["bidding"] = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: bidding(*args), lambda: bidding_ref(*args),
                  "bidding_kernel"))
    row["library_ms"] = took(row, "library_ms", time_ms(
        lambda: torch.topk(masked, 2, dim=-1, largest=False)))
    row["cold_ms"] = took(row, "cold_ms", time_cold_ms(
        lambda: bidding(*args), "bidding_kernel"))
    log(f"[kernels] K4 L2-warm {row['ms']:.4f} ms, L2-cold "
        f"{row['cold_ms']:.4f} ms; bound {b_ms:.4f} ms")

    B, n = MATCH_B, MATCH_N
    err = max(compare(frontier(*a), frontier_ref(*a), f"K5 {share:.0%}")
              for share, a in inputs.items())
    args5 = inputs[0.5]
    adj, root, match = args5
    rows = torch.arange(n, device=dev, dtype=torch.int64)
    cand = (adj & (root < INF)[..., None]
            & (match[..., None] != torch.arange(n, device=dev)))
    key = torch.where(cand, (root.to(torch.int64)[..., None] << 32)
                      | rows[:, None], torch.iinfo(torch.int64).max)
    labeled = int((root < INF).sum())
    b_ms, b_by = k5_bound(labeled, launches=1)
    row = out["frontier"] = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        labeled_rows=labeled, rows=B * n,
        **timings(lambda: frontier(*args5), lambda: frontier_ref(*args5),
                  "frontier_"))
    row["library_ms"] = took(row, "library_ms",
                             time_ms(lambda: torch.min(key, dim=-2)))
    # the labeled rows' adjacency fits in the 50 MB L2 across the repeated
    # calls of the time above; time it from cold too
    row["cold_ms"] = took(row, "cold_ms", time_cold_ms(
        lambda: frontier(*args5), "frontier_"))
    g = launch_geometry(B, n, n, True)
    log(f"[kernels] K5 launch as launch_geometry picks it: {g}; the card "
        f"holds {max_active_clusters(g)} such clusters at once, the grid "
        f"has {g.grid[0] * g.grid[1] // g.cluster}")
    row["regimes"] = {}
    for share, a in inputs.items():
        labeled = int((a[1] < INF).sum())
        name = f"{share:.2f}"
        if share == 0.5:
            warm, cold = row["ms"], row["cold_ms"]
        else:
            warm = took(row, f"regimes.{name}.ms",
                        time_ms(lambda: frontier(*a), symbol="frontier_"))
            cold = took(row, f"regimes.{name}.cold_ms", time_cold_ms(
                lambda: frontier(*a), "frontier_"))
        row["regimes"][name] = dict(labeled_rows=labeled, ms=warm,
                                    cold_ms=cold)
        bound_share = k5_bound(labeled, launches=1)[0]
        log(f"[k5] {labeled} of {B * n} rows labeled ({share:.0%}): "
            f"L2-warm {warm:.4f} ms, L2-cold {cold:.4f} ms "
            f"({L2_FLUSH_BYTES >> 20} MB written before each call); bound "
            f"{bound_share:.4f} ms by bytes ({bound_share / warm:.0%} / "
            f"{bound_share / cold:.0%} of it)")
    return out


def k4_bound() -> tuple[float, str]:
    """K4's least time for one call at the assignment phase's shape: c and
    mask read once (5 B per entry), p_y read and 3 outputs written (16 B
    per row); about 4 integer ops per entry."""
    B, n = ASSIGN_B, ASSIGN_N
    return bound(5 * B * n * n + 16 * B * n, 4 * B * n * n)


def k4_geometry(args):
    """Log K4's launch at the assignment phase's shape as
    ``launch_geometry`` picks it for these tensors; it must be the vector
    path."""
    from repro_torch.kernels.bidding.kernel import (aligned_for_vectors,
                                                    launch_geometry)
    *batch, n_r, n_c = args[0].shape
    g = launch_geometry(int(np.prod(batch)), n_r, n_c,
                        aligned_for_vectors(*args))
    log(f"[kernels] K4 launch as launch_geometry picks it: {g}")
    if not g.vec:
        raise AssertionError(f"K4 at {tuple(args[0].shape)}: the scalar "
                             f"path, not the vector path: {g}")
    return g


def k5_bound(reads: int, launches: int) -> tuple[float, str]:
    """K5's least time over ``launches`` calls at the matching phase's
    shape that read ``reads`` labeled rows in all: each labeled row's
    adjacency once (1 B per entry; no other row is needed), both row
    labels (8 B per row) and both outputs (8 B per column) once per call;
    about 4 ops per entry read."""
    need = reads * MATCH_N
    return bound(need + 16 * launches * MATCH_B * MATCH_N, 4 * need)


def flash_inputs(rng, dims, dtype, dev):
    """Random normal q, k, v of the sweep's ``(B, Sq, Sk, H, KV, dh, dv)``."""
    B, Sq, Sk, H, KV, dh, dv = dims
    return tuple(torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                              device=dev).to(dtype)
                 for shape in ((B, Sq, H, dh), (B, Sk, KV, dh),
                               (B, Sk, KV, dv)))


def flash_bounds(dims, causal: bool, dtype) -> dict:
    """K6's least time at ``dims``: q, k, v read and o written once, and
    2*dh + 2*dv flops per (query, key) pair (pos_q >= pos_k when causal)
    at the rate of the units the kernel runs them on (float32: three TF32
    products each; bfloat16: one bf16 product), and at the FFMA rate the
    first design ran on (``ffma_ms``)."""
    B, Sq, Sk, H, KV, dh, dv = dims
    es = 4 if dtype == torch.float32 else 2
    if causal:
        pairs = B * H * sum(min(i + 1, Sk) for i in range(Sq))
    else:
        pairs = B * H * Sq * Sk
    flops = pairs * (2 * dh + 2 * dv)
    nbytes = es * (B * Sq * H * (dh + dv) + B * Sk * KV * (dh + dv))
    if dtype == torch.float32:
        b_ms, b_by = bound(nbytes, 3 * flops, TF32_OPS_PER_S)
    else:
        b_ms, b_by = bound(nbytes, flops, BF16_OPS_PER_S)
    return dict(bound_ms=b_ms, bound_by=b_by, causal_pairs=pairs,
                ffma_ms=bound(nbytes, flops)[0])


def kernels_flash(dev) -> dict:
    """K6 against its plain version over FLASH_SWEEP, FLASH_TAILS and at
    the serve path's prefill shape in float32 and bfloat16 (max abs error
    within FLASH_TOL), with timings and ``F.scaled_dot_product_attention``
    (causal, GQA, on the head-major views) as its one-call yardstick, timed
    only."""
    import torch.nn.functional as F

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_fwd, launch_geometry)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.default_rng(SEED + 2)
    cfg = get_config(SERVE_ARCH)
    serve = (SERVE_B, SERVE_S, SERVE_S, cfg.n_heads, cfg.n_kv_heads, cfg.dh,
             cfg.dh)
    cases = FLASH_SWEEP + FLASH_TAILS + [(serve, True, torch.bfloat16),
                                         (serve, True, torch.float32)]
    sweep = []
    for dims, causal, dtype in cases:
        q, k, v = flash_inputs(rng, dims, dtype, dev)
        got = flash_attention_fwd(q, k, v, causal=causal)
        want = flash_attention_ref(q, k, v, causal=causal)
        if got.dtype != dtype or got.shape != want.shape:
            raise AssertionError(f"K6 {dims}: {got.dtype} {got.shape}")
        err = (got.float() - want.float()).abs().max().item()
        if not err <= FLASH_TOL[dtype]:
            raise AssertionError(f"K6 {dims} causal={causal} {dtype}: max "
                                 f"abs err {err} > {FLASH_TOL[dtype]}")
        sweep.append(dict(dims=list(dims), causal=causal,
                          dtype=str(dtype).split(".")[1], max_abs_err=err))
        log(f"[kernels] K6 {dims} causal={causal} {dtype}: max abs err "
            f"{err:.3g} (tolerance {FLASH_TOL[dtype]})")
        if dims == serve and dtype == torch.bfloat16:
            bf16 = time_ms(lambda: flash_attention_fwd(q, k, v, causal=True),
                           symbol="flash_fwd_")
            bf16_bound = flash_bounds(dims, True, dtype)
            log(f"[kernels] K6 bfloat16 at the serve shape: device "
                f"{bf16.ms:.4f} ms, bound {bf16_bound['bound_ms']:.4f} ms by "
                f"{bf16_bound['bound_by']}")
    geo = launch_geometry(serve[0], serve[1], serve[3], serve[5], serve[6])
    log(f"[kernels] K6 serve launch as launch_geometry picks it: {geo}")
    b = flash_bounds(serve, True, torch.float32)
    log(f"[kernels] K6 serve bounds: {b['bound_ms']:.4f} ms by "
        f"{b['bound_by']} (split TF32), {b['ffma_ms']:.4f} ms at the FFMA "
        f"rate")
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                              enable_gqa=True)
    lib_err = (library().transpose(1, 2) - want).abs().max().item()
    log(f"[kernels] K6 yardstick scaled_dot_product_attention: max abs "
        f"diff {lib_err:.3g} from the plain version (timed only)")
    row = dict(equal=False, tolerance=FLASH_TOL[torch.float32],
               max_abs_err=sweep[-1]["max_abs_err"], bound_ms=b["bound_ms"],
               bound_by=b["bound_by"], causal_pairs=b["causal_pairs"],
               sweep=sweep,
               **timings(lambda: flash_attention_fwd(q, k, v, causal=True),
                         lambda: flash_attention_ref(q, k, v, causal=True),
                         "flash_fwd_"))
    row["bf16_ms"] = took(row, "bf16_ms", bf16)
    row["library_ms"] = took(row, "library_ms", time_ms(library))
    return {"flash_attention_fwd": row}


def timings(kernel, plain, symbol: str) -> dict:
    """Device and loop ms per call of a kernel's wrapper, whose kernel's
    name holds ``symbol``, and of its plain version (see ``time_ms``), with
    where each device ms came from (``ms_from``)."""
    k, p = time_ms(kernel, symbol=symbol), time_ms(plain)
    return dict(ms=k.ms, plain_ms=p.ms, loop_ms=k.loop_ms,
                plain_loop_ms=p.loop_ms,
                ms_from={"ms": k.source, "plain_ms": p.source})


def counters():
    from repro_torch.kernels.bfs_relabel.kernel import bfs_relabel_sweeps
    from repro_torch.kernels.bidding.kernel import bidding
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.frontier.kernel import frontier
    from repro_torch.kernels.grid_push.kernel import (grid_push_decide,
                                                      grid_push_decide_sched)
    return {f.__name__: f for f in (grid_push_decide, grid_push_decide_sched,
                                    bfs_relabel_sweeps, bidding, frontier,
                                    flash_attention_fwd)}


def reset_counts():
    for f in counters().values():
        f.launches = 0
    counters()["bfs_relabel_sweeps"].sweeps = 0


def read_counts() -> dict:
    """Launches per kernel, and K3's sweeps under ``K3_SWEEPS``."""
    got = {name: f.launches for name, f in counters().items()}
    got[K3_SWEEPS] = counters()["bfs_relabel_sweeps"].sweeps
    return got


def require_launched(counts: dict, names, phase: str):
    for name in names:
        if counts[name] <= 0:
            raise AssertionError(f"{phase}: {name} was never launched")


def require_not_launched(counts: dict, names, phase: str):
    for name in names:
        if counts[name] != 0:
            raise AssertionError(f"{phase}: {name} was launched "
                                 f"{counts[name]} times")


def require_same(a: dict, b: dict, what: str):
    """Every leaf of two ``to_numpy`` results equal, dtypes included
    (nested dicts too)."""
    for key, v in a.items():
        if isinstance(v, dict):
            require_same(v, b[key], f"{what}.{key}")
        elif (v is None) != (b[key] is None) or (v is not None and (
                v.dtype != b[key].dtype or not np.array_equal(v, b[key]))):
            raise AssertionError(f"{what}: results differ in {key}")


def solve(fn, *a, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn(*a, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def profile(what: str, wall: float, fn, *a, **kw) -> dict:
    """One more run of ``fn`` under ``torch.profiler``: device busy time
    (the sum of every device op's own time), the ops that take most of it,
    and the port's own kernels (their time inside the solve). The idle
    share divides busy by ``wall``, the unprofiled solve's time, since the
    profiler slows the host. Outside the counted runs. Returns the busy
    seconds, the idle share, the number of device ops (kernels, copies,
    memsets) and ``{kernel: (ms, launches)}`` of the port's kernels."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       acc_events=True) as prof:
        _, secs = solve(fn, *a, **kw)
    rows = device_events(prof)
    busy = sum(r[0] for r in rows) / 1e6
    launches = sum(r[1] for r in rows)
    log(f"[profile] {what}: wall {wall:.4f} s unprofiled ({secs:.4f} s "
        f"profiled), device busy {busy:.4f} s, idle share "
        f"{1 - busy / wall:.3f}, {launches} device ops")
    for us, count, key in rows[:8]:
        log(f"[profile]   {us / 1e3:9.3f} ms  {count:6d} x  {key[:90]}")
    port = {}
    for us, count, key in rows:
        if key.startswith(PORT_KERNEL_SYMBOLS):
            name = key.split("::", 1)[1].split("(")[0].split("<")[0]
            ms, n = port.get(name, (0.0, 0))
            port[name] = (ms + us / 1e3, n + count)
    for name, (ms, count) in port.items():
        log(f"[profile]   port kernel {name}: {ms:.3f} ms over {count} "
            f"launches, {ms / count:.4f} ms each")
    return dict(busy_s=busy, idle_share=1 - busy / wall, launches=launches,
                port_kernels=port)


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
    in_solve = {}
    for backend in ("pallas", "xla"):
        prof = profile(f"backend={backend} batch", walls[backend],
                       maxflow_grid_batch, prob, backend=backend, device=dev)
        in_solve[backend] = grid_in_solve(backend, prof, counts[backend],
                                          B * H * W, with_ds=False)
    require_same(results["pallas"], results["xla"], "pallas vs xla")
    return prob, in_solve


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
    prof = profile("backend=balanced batch", batch_wall, maxflow_grid_batch,
                   prob, backend="balanced", device=dev)
    in_solve = {"balanced_batch": grid_in_solve(
        "balanced_batch", prof, counts["balanced_batch"], B * H * W,
        with_ds=True)}
    prof = profile(f"backend=balanced checkerboard {CHECKERBOARD}",
                   board_wall, maxflow_grid, board, backend="balanced",
                   max_rounds=500_000, device=dev)
    in_solve["balanced_checkerboard"] = grid_in_solve(
        "balanced_checkerboard", prof, counts["balanced_checkerboard"],
        CHECKERBOARD[0] * CHECKERBOARD[1], with_ds=True)
    return in_solve


def grid_in_solve(what: str, prof: dict, counts: dict, nodes: int,
                  with_ds: bool) -> dict:
    """The port's kernels inside one profiled grid solve: device ms,
    launches and ms per launch; for K3 also the solve's sweeps (from the
    counters of its unprofiled run) and the bound per call (``k3_bound``:
    the sink-only ``bfs_heights`` relaxes ``dt`` alone, the balanced
    relabel both planes), which is logged and not returned. Adds the
    solve's busy seconds and idle share."""
    out = dict(busy_s=prof["busy_s"], idle_share=prof["idle_share"])
    for name, (ms, n) in prof["port_kernels"].items():
        out[name] = dict(ms=ms, launches=n, ms_per_launch=ms / n)
        if name.startswith("bfs_relabel_sweep"):
            b_ms = k3_bound(nodes, with_ds)[0]
            out[name]["sweeps"] = counts[K3_SWEEPS]
            log(f"[k3] {what}: {counts['bfs_relabel_sweeps']} launches, "
                f"{counts[K3_SWEEPS]} sweeps; {ms:.3f} ms in the solve, "
                f"{ms / n:.4f} ms per launch against {b_ms:.4f} ms per call "
                f"({ms / n / b_ms:.2f}x the bound)")
    return out


def solve_in_turns(what: str, dev, counts: dict, check, fn, *a,
                   **kw) -> dict:
    """Solve with ``backend="pallas"``, ``"xla"``, ``"xla"``, ``"pallas"``,
    in turns, so host drift over the four solves hits both backends alike,
    after one uncounted warm-up solve of the first instance per backend.

    Before each solve the launch counts are set to 0 and just after it
    they are read: the first solve of a backend records them under
    ``counts[f"{what}_{backend}"]``, and the second must launch the same.
    ``check(solve_id, res)`` runs on every result; the second result of a
    backend must equal its first on every leaf, and ``pallas`` must equal
    ``xla``. Then each backend is profiled once (``profile``) against the
    mean of its two unprofiled walls. Returns ``{backend: [wall, wall]}``
    and ``{backend: profile}``.
    """
    from repro_torch.interop import to_numpy
    for backend in ("pallas", "xla"):   # warm-up: loads the kernels used
        solve(fn, *(x[:1] for x in a), backend=backend, device=dev, **kw)
    results, walls = {}, {"pallas": [], "xla": []}
    for backend in ("pallas", "xla", "xla", "pallas"):
        solve_id = f"{what}_{backend}"
        reset_counts()
        res, wall = solve(fn, *a, backend=backend, device=dev, **kw)
        got = read_counts()
        log(f"[{what}] {backend}: {wall:.4f} s, launches {got}")
        check(solve_id, res)
        if solve_id in counts:
            if got != counts[solve_id]:
                raise AssertionError(f"{solve_id}: launches {got} != first "
                                     f"solve's {counts[solve_id]}")
            require_same(to_numpy(res), results[backend], f"{solve_id} rerun")
        counts.setdefault(solve_id, got)
        results.setdefault(backend, to_numpy(res))
        walls[backend].append(wall)
    require_same(results["pallas"], results["xla"], what)
    profiles = {backend: profile(f"{what} {backend}",
                                 sum(walls[backend]) / 2, fn, *a,
                                 backend=backend, device=dev, **kw)
                for backend in ("pallas", "xla")}
    return walls, profiles


def phase_assignment(dev, counts: dict) -> dict:
    """``solve_assignment`` on ASSIGN_B x n^2 weights for both methods on
    both backends: scipy's optimal weights, the JAX package's rounds,
    ``pallas`` equal to ``xla`` on every leaf, K4 on ``pallas`` only and
    on its vector path in every launch (a hook on the wrapper's
    ``launch_geometry``, restored after). Returns K4's device time in each
    method's profiled ``pallas`` solve: ms, launches, ms per launch and
    the bound per launch (``k4_bound``)."""
    from repro_torch.core.assignment.cost_scaling import solve_assignment
    from repro_torch.core.assignment.ref import optimal_weight
    from repro_torch.kernels.bidding import kernel as bidk
    w = assignment_weights()
    optimum = [optimal_weight(x) for x in w]
    log(f"[assignment] scipy optimal weights {optimum}")
    in_solve = {}
    geometry, paths = bidk.launch_geometry, set()

    def recorded(*a):
        g = geometry(*a)
        paths.add("vector" if g.vec else "scalar")
        return g
    for method in ("auction", "pushrelabel"):
        def check(solve_id, res):
            log(f"[{solve_id}] weights {res.weight.tolist()}, rounds "
                f"{res.rounds.tolist()}")
            if not bool(res.converged.all()):
                raise AssertionError(f"{solve_id}: not converged")
            if res.weight.tolist() != optimum:
                raise AssertionError(f"{solve_id}: weights != scipy")
            if tuple(res.rounds.tolist()) != ASSIGN_ROUNDS_WANT[method]:
                raise AssertionError(f"{solve_id}: rounds != JAX package's "
                                     f"{ASSIGN_ROUNDS_WANT[method]}")

        what = f"assignment_{method}"
        bidk.launch_geometry = recorded
        try:
            _, profiles = solve_in_turns(what, dev, counts, check,
                                         solve_assignment, w, method=method)
        finally:
            bidk.launch_geometry = geometry
        require_launched(counts[f"{what}_pallas"], ["bidding"], what)
        require_not_launched(counts[f"{what}_xla"], ["bidding"], what)
        if paths != {"vector"}:
            raise AssertionError(f"{what}: K4 took the paths {paths}, not "
                                 f"the vector path alone")
        ms, n = profiles["pallas"]["port_kernels"]["bidding_kernel"]
        b_ms = k4_bound()[0]
        in_solve[method] = dict(ms=ms, launches=n, ms_per_launch=ms / n,
                                bound_ms_per_launch=b_ms)
        log(f"[k4] {what} pallas: {n} bidding_kernel kernels in the "
            f"profiled solve ({counts[f'{what}_pallas']['bidding']} launches "
            f"counted in the first), K4 device {ms:.4f} ms per "
            f"profiled solve, {ms / n:.4f} per launch against a bound of "
            f"{b_ms:.4f} ms per launch ({b_ms / (ms / n):.0%} of it); "
            f"bound {b_ms * n:.4f} ms per solve")
    return in_solve


def phase_matching(dev, counts: dict) -> dict:
    """``match_bipartite_batch`` on MATCH_B graphs of n^2 on both backends:
    Hopcroft-Karp's cardinalities, the JAX package's phases, the backends
    equal on every leaf, K5 on ``pallas`` only, once per frontier sweep
    (``K5_READS_WANT``: launches in the solve, device kernels in its
    profile, and the labeled rows they read, from ``k5_reads``). Returns
    the walls and K5's device time in the profiled ``pallas`` solve."""
    from repro_torch.core.matching import hopcroft_karp, match_bipartite_batch
    adj = matching_adjacency()
    oracle = [hopcroft_karp(a)[2] for a in adj]
    log(f"[matching] Hopcroft-Karp cardinalities {oracle}")

    def check(solve_id, res):
        log(f"[{solve_id}] cardinalities {res.cardinality.tolist()}, phases "
            f"{res.rounds.tolist()}")
        if not bool(res.converged.all()):
            raise AssertionError(f"{solve_id}: not converged")
        if res.cardinality.tolist() != oracle:
            raise AssertionError(f"{solve_id}: cardinalities != oracle")
        if tuple(res.rounds.tolist()) != MATCH_ROUNDS_WANT:
            raise AssertionError(f"{solve_id}: phases != JAX package's "
                                 f"{MATCH_ROUNDS_WANT}")

    walls, profiles = solve_in_turns("matching", dev, counts, check,
                                     match_bipartite_batch, adj)
    require_launched(counts["matching_pallas"], ["frontier"], "matching")
    require_not_launched(counts["matching_xla"], ["frontier"], "matching")
    k5 = {name: v for name, v in profiles["pallas"]["port_kernels"].items()
          if name.startswith("frontier_")}
    ms, kernels = (sum(v[i] for v in k5.values()) for i in range(2))
    launches, reads = k5_reads(dev, adj, check)
    if (launches, reads) != K5_READS_WANT or kernels != launches:
        raise AssertionError(
            f"matching pallas: K5 ran {launches} launches reading {reads} "
            f"labeled rows ({kernels} frontier_ kernels in the profiled "
            f"solve), not {K5_READS_WANT}")
    b_ms = k5_bound(reads, launches)[0]
    log(f"[k5] matching pallas: {launches} launches, {reads} labeled-row "
        f"reads ({reads / launches / (MATCH_B * MATCH_N):.1%} of the rows "
        f"per launch); bound {b_ms:.4f} ms per solve, "
        f"{b_ms / launches:.4f} per launch; K5 device {ms:.4f} ms per "
        f"profiled solve, {ms / launches:.4f} per launch (the bound is "
        f"{b_ms / ms:.0%} of it)")
    return {"matching": walls,
            "k5_in_solve": dict(ms=ms, launches=kernels,
                                ms_per_launch=ms / kernels,
                                labeled_row_reads=reads)}


def k5_reads(dev, adj, check) -> tuple[int, int]:
    """One more unprofiled ``pallas`` solve, its result checked like the
    others, with a hook on ``core.matching.bfs._expand`` (restored after)
    that counts K5's calls and the labeled rows each reads (root < INF,
    over the whole batch). Returns ``(calls, labeled rows)``; the launch
    count must equal the calls."""
    from repro_torch.core.matching import bfs, match_bipartite_batch
    from repro_torch.kernels.frontier.ref import INF
    expand, seen = bfs._expand, []

    def counted(adj_, root_row, match_row, backend):
        if backend == "pallas":
            seen.append(int((root_row < INF).sum()))
        return expand(adj_, root_row, match_row, backend)
    bfs._expand = counted
    try:
        reset_counts()
        res, _ = solve(match_bipartite_batch, adj, backend="pallas",
                       device=dev)
        launched = read_counts()["frontier"]
    finally:
        bfs._expand = expand
    check("matching_pallas_counted", res)
    if launched != len(seen):
        raise AssertionError(f"K5 launched {launched} times in "
                             f"{len(seen)} frontier sweeps")
    return len(seen), sum(seen)


def serve_prompts(vocab: int, B: int = SERVE_B, S: int = SERVE_S,
                  seed: int = SEED + 1) -> np.ndarray:
    """The serve phase's ``(B, S)`` int32 prompt tokens."""
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


def top5_records(logits: np.ndarray) -> dict:
    """Per request of one step's ``(B, vocab)`` logits: the five largest
    (ids, first index first among equals, as ``argmax``), their values and
    the largest |logit|."""
    ids = np.argsort(-logits, axis=-1, kind="stable")[:, :5]
    return {"ids": ids.tolist(),
            "logits": np.take_along_axis(logits, ids, -1).tolist(),
            "absmax": np.abs(logits).max(-1).tolist()}


def port_serve(model, prompts: torch.Tensor, max_new: int, S_max: int):
    """One greedy generation through ``make_prefill_step`` and
    ``make_serve_step``, each step timed and its launch counts read (set
    to 0 just before it). Returns the steps' ``(tokens, logits)`` as numpy,
    the prefill wall, the decode steps' walls and the counts of the
    prefill and of each decode step."""
    from repro_torch.models.model import init_caches
    from repro_torch.serve.engine import make_prefill_step, make_serve_step
    dev = prompts.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda: None
    B = prompts.shape[0]
    caches = init_caches(model.cfg, B, S_max, dtype=torch.float32, device=dev)
    prefill, step = make_prefill_step(model), make_serve_step(model)
    sync()
    reset_counts()
    t0 = time.perf_counter()
    nxt, state = prefill(prompts, caches)
    sync()
    t_prefill = time.perf_counter() - t0
    c_prefill = read_counts()
    outs = [(nxt, state.logits)]
    t_steps, c_steps = [], []
    for _ in range(max_new - 1):
        reset_counts()
        t0 = time.perf_counter()
        nxt, state = step(state)
        sync()
        t_steps.append(time.perf_counter() - t0)
        c_steps.append(read_counts())
        outs.append((nxt, state.logits))
    steps = [(t.cpu().numpy(), lg.float().cpu().numpy()) for t, lg in outs]
    return steps, t_prefill, t_steps, c_prefill, c_steps, state


def check_serve(steps, want: list, tol: float = LOGIT_TOL) -> dict:
    """Hold a generation's ``steps`` (``(tokens (B,), logits (B, vocab))``
    per step) to the JAX package's ``top5_records`` per step.

    Per request and step: the port's logits at JAX's five ids lie within
    ``tol`` x JAX's largest |logit| of JAX's values; where JAX's top-2 gap
    exceeds that tolerance, the port's token is JAX's first id. At the
    first step where the gap does not (a real near-tie), that request's
    later steps are not compared: its continuation may rightly differ.
    Returns the steps compared per request, the near-tie steps and the
    largest error as a share of its tolerance."""
    B = len(want[0]["ids"])
    compared, ties, worst = [0] * B, [], 0.0
    for b in range(B):
        for t, ((tokens, logits), rec) in enumerate(zip(steps, want)):
            ids = np.asarray(rec["ids"][b])
            vals = np.asarray(rec["logits"][b], dtype=np.float64)
            tol_b = tol * rec["absmax"][b]
            err = np.abs(logits[b, ids].astype(np.float64) - vals).max()
            worst = max(worst, err / tol_b)
            if err > tol_b:
                raise AssertionError(
                    f"serve step {t} request {b}: top-5 logits differ from "
                    f"the JAX package's by {err:.3g} > {tol_b:.3g}")
            compared[b] += 1
            if vals[0] - vals[1] <= tol_b:
                ties.append((b, t))
                break
            if int(tokens[b]) != int(ids[0]):
                raise AssertionError(
                    f"serve step {t} request {b}: token {int(tokens[b])} != "
                    f"the JAX package's {int(ids[0])} (gap "
                    f"{vals[0] - vals[1]:.3g})")
    return dict(steps_compared=compared, near_ties=ties,
                worst_err_over_tol=float(worst))


def phase_serve(dev, counts: dict) -> dict:
    """smollm-135m at full width on ``numpy_params`` weights: a warm-up
    and two timed generations of SERVE_B x SERVE_S prompts and SERVE_NEW
    tokens, each held to the JAX package's constants, K6 launched once
    per layer in each prefill and never in decode; then one profiled
    prefill and one profiled decode step."""
    from repro_torch.configs.base import get_config
    from repro_torch.interop import model_from_params, numpy_params
    from repro_torch.models.model import init_caches
    from repro_torch.serve.engine import make_prefill_step, make_serve_step
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the serve check assumes "
                             "full float32")
    want = json.loads(SERVE_CONSTANTS.read_text())
    setup = dict(arch=SERVE_ARCH, B=SERVE_B, S=SERVE_S, max_new=SERVE_NEW,
                 seed=SEED)
    if {k: want[k] for k in setup} != setup:
        raise AssertionError(f"{SERVE_CONSTANTS.name} was made for "
                             f"{ {k: want[k] for k in setup} }, not {setup}")
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    model = model_from_params(cfg, numpy_params(cfg, SEED), device=dev)
    prompts = torch.tensor(serve_prompts(cfg.vocab, SERVE_B, SERVE_S),
                           device=dev)
    log(f"[serve] {SERVE_ARCH}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {sum(p.numel() for p in model.parameters())} "
        f"parameters on the card in {time.perf_counter() - t0:.1f} s")
    S_max = SERVE_S + SERVE_NEW
    walls = []
    for run in ("warm-up", "run 1", "run 2"):
        steps, t_pre, t_steps, c_pre, c_steps, state = port_serve(
            model, prompts, SERVE_NEW, S_max)
        got = check_serve(steps, want["steps"])
        if c_pre["flash_attention_fwd"] != cfg.n_layers:
            raise AssertionError(f"serve prefill: K6 launched "
                                 f"{c_pre['flash_attention_fwd']} times, not "
                                 f"once per layer ({cfg.n_layers})")
        require_not_launched(c_pre, [n for n in c_pre
                                     if n != "flash_attention_fwd"],
                             "serve prefill")
        for c in c_steps:
            require_not_launched(c, list(c), "serve decode step")
        tokens = np.stack([t for t, _ in steps], 1)
        log(f"[serve] {run}: prefill {t_pre * 1e3:.2f} ms "
            f"({SERVE_B * SERVE_S / t_pre:.0f} tok/s), decode "
            f"{np.mean(t_steps) * 1e3:.3f} ms per token step "
            f"({SERVE_B / np.mean(t_steps):.0f} tok/s), launches per "
            f"prefill {c_pre['flash_attention_fwd']}; JAX check {got}; "
            f"request 0 tokens {tokens[0].tolist()}")
        if run != "warm-up":
            walls.append((t_pre, float(np.mean(t_steps))))
            counts.setdefault("serve_prefill", c_pre)
            counts.setdefault("serve_decode", {
                n: sum(c[n] for c in c_steps) for n in c_pre})
    t_pre = sum(w[0] for w in walls) / len(walls)
    t_step = sum(w[1] for w in walls) / len(walls)
    caches = init_caches(cfg, SERVE_B, S_max, dtype=torch.float32,
                         device=dev)
    pre = profile("serve prefill 8 x 1024", t_pre, make_prefill_step(model),
                  prompts, caches)
    # every K6 launch of the prefill on the wgmma kernel
    k6 = {name: n for name, (_, n) in pre["port_kernels"].items()}
    if k6 != {"flash_fwd_wgmma": cfg.n_layers}:
        raise AssertionError(f"serve prefill: port kernels {k6}, not "
                             f"{cfg.n_layers} launches of flash_fwd_wgmma")
    dec = profile("serve decode step", t_step, make_serve_step(model), state)
    return dict(walls=walls, prefill=pre, decode=dec)


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
    prob, in_solve = phase_main(dev, problems, oracle, counts)
    in_solve.update(phase_balanced(dev, prob, oracle, counts))
    kernels["bidding"]["in_solve"] = phase_assignment(dev, counts)
    kernels["frontier"]["in_solve"] = phase_matching(dev, counts)[
        "k5_in_solve"]
    serve = phase_serve(dev, counts)
    k6 = serve["prefill"]["port_kernels"]
    kernels["flash_attention_fwd"]["prefill_ms_per_launch"] = (
        sum(ms for ms, _ in k6.values()) / sum(n for _, n in k6.values()))
    # K1-K3 inside each profiled grid solve, under the wrapper's name
    for name, symbol in (("grid_push_decide", "grid_push_decide_kernel"),
                         ("grid_push_decide_sched",
                          "grid_push_decide_sched_kernel"),
                         ("bfs_relabel_sweeps", "bfs_relabel_sweep_tiles")):
        kernels[name]["in_solve"] = {k: v[symbol] for k, v in in_solve.items()
                                     if symbol in v}
    kernels["bfs_relabel_sweeps"]["sweeps_per_solve"] = {
        k: c[K3_SWEEPS] for k, c in counts.items() if c[K3_SWEEPS]}
    busy = {k: (v["busy_s"], v["idle_share"]) for k, v in in_solve.items()}
    log(f"[grid] device busy (s) and idle share per solve: {busy}")

    # max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by (+ details;
    # K6 replaces equal with its tolerance) come from phase_kernels;
    # launches are summed over the solves, and listed per solve where
    # non-zero
    rows = [{**dict(name=name, route="cuda", source=source,
                    replaces=replaces,
                    launches=sum(c[name] for c in counts.values()),
                    launches_per_solve={k: c[name]
                                        for k, c in counts.items() if c[name]},
                    equal=True, card=card), **kernels[name]}
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
