"""K4 on the card: its design against the first one, and what its time is
made of.

    python3 tests/torch_smoke_k4_variants.py [--parent OTHER.cu]

Builds ``src/repro_torch/kernels/csrc/bidding.cu`` as variants, each the
source with text substitutions, into libraries of their own (one ``nvcc``
each, all at once):

- ``kernel``: the source as it is, launched as ``launch_geometry`` picks
  (run ``kernel``: the vector path at these inputs) and on its scalar
  path (run ``scalar``);
- ``chunks1``, ``chunks4``: a lane issuing the loads of 1 or 4 chunks of
  128 columns before it folds them (the kernel: 2);
- ``l1_allocate``: cost and mask loads through L1 (the kernel: around
  it);
- ``empty``: the kernel's launch with a kernel that returns at once;
- ``loads_only``: every byte loaded as the kernel loads it, and no fold
  (each entry xor-ed into the triple, which is stored);
- ``stamps``: the kernel with global-timer stamps of each block's start
  and each warp's end;
- ``parent`` (with ``--parent``): ``OTHER.cu``, a K4 source with the C
  entry of the first design (a grid of ``(n_r / 8, B)``): the way to time
  the parent commit's kernel in the same call.

Inputs: the smoke's (``chip_smoke.k4_k5_inputs``: 8 x 512^2), its first
instance alone (1 x 512^2) and 2 x 2048^2 (42 MB, close to the L2). The
runs that compute the function are held bit for bit to the plain version
on each; every run is timed in turns (the runs in order, then in
reverse) L2-warm (``chip_smoke.time_ms``), L2-cold after writes
(``chip_smoke.time_cold_ms``: 128 MB written before each call, so the
call also writes back the dirty lines it evicts) and L2-cold after reads
(``clean_cold_ms``: 128 MB read before each call, nothing to write back).
Then ``kernel`` and ``parent`` run inside the smoke's assignment solves
(8 x 512^2, both methods, ``pallas``), in turns, each solve profiled for
K4's time per launch. Prints registers (``-Xptxas -v``) and each input's
block timeline from ``stamps`` on stderr, the ``nvidia-smi`` name and
power limit, and one JSON line of device ms per input, run and cache
state and per launch in each solve. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

_GT = ("[&] { unsigned long long g; asm volatile(\"mov.u64 %0, "
       "%globaltimer;\" : \"=l\"(g)); return (long long)g; }()")
_LANE = "  const int lane = threadIdx.x & 31;\n"
_STORE = "  if (lane == 0) {\n    min1[r] = t.m1;\n"
_STAMPS = {
    "__global__ void __launch_bounds__(kThreads) bidding_kernel(":
    "__device__ long long g_stamps[4096][9];\n"
    "__global__ void __launch_bounds__(kThreads) bidding_kernel(",
    _LANE: _LANE + "  const long long g_start = " + _GT + ";\n",
    _STORE: "  if (lane == 0) {\n"
            "    g_stamps[blockIdx.x][1 + (threadIdx.x >> 5)] = " + _GT
            + ";\n    if (threadIdx.x == 0) g_stamps[blockIdx.x][0] = "
              "g_start;\n    min1[r] = t.m1;\n",
}
_STAMPS_GET = """
extern "C" int bidding_stamps(long long* out, int blocks) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_stamps, sizeof(long long) * 9 * blocks));
}
"""
_CHUNKS = "constexpr int kChunks = 2;"
# name: text substitutions
VARIANTS = {
    "kernel": {},
    "chunks1": {_CHUNKS: "constexpr int kChunks = 1;"},
    "chunks4": {_CHUNKS: "constexpr int kChunks = 4;"},
    "l1_allocate": {"ld.global.nc.L1::no_allocate.v4.s32":
                    "ld.global.nc.v4.s32",
                    "ld.global.nc.L1::no_allocate.u32": "ld.global.nc.u32"},
    "empty": {_LANE: "  if (n_r > 0) return;\n" + _LANE},
    "loads_only": {"  if (v < t.m1 || (v == t.m1 && j < t.a1)) {":
                   "  t.m1 ^= v;\n  return;\n"
                   "  if (v < t.m1 || (v == t.m1 && j < t.a1)) {"},
    "stamps": _STAMPS,
}
# run: (library, path: "auto" as launch_geometry picks, "scalar", or
# None for the parent's own launch); the runs that compute the function
EXACT = {"kernel": ("kernel", "auto"), "scalar": ("kernel", "scalar"),
         "chunks1": ("chunks1", "auto"), "chunks4": ("chunks4", "auto"),
         "l1_allocate": ("l1_allocate", "auto"), "parent": ("parent", None)}
ABLATIONS = {"empty": ("empty", "auto"), "loads_only": ("loads_only", "auto")}


def build(name: str, subs: dict, src: pathlib.Path | None = None):
    """Start ``nvcc`` on the source with ``subs`` applied (``src``, the
    parent's source, as it is)."""
    from repro_torch.kernels import _build
    out_dir = _build.BUILD_DIR / "k4_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = src or out_dir / f"{name}.cu"
    if src is None:
        text = (_build.CSRC / "bidding.cu").read_text()
        for old, new in subs.items():
            if text.count(old) != 1:
                raise AssertionError(f"{name}: the source holds {old!r} "
                                     f"{text.count(old)} times, not once")
            text = text.replace(old, new)
        if name == "stamps":
            text += _STAMPS_GET
        path.write_text(text)
    lib = out_dir / f"lib{name}.so"
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(_build.CSRC), "-o", str(lib), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def wide_inputs(dev):
    """2 x 2048^2 at the smoke's kind of costs, prices and mask."""
    rng = np.random.default_rng(7)
    B, n = 2, 2048
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=dev)  # noqa: E731
    m = rng.random((B, n, n)) < 0.2
    m[:, ::64] = True
    return (t(-(n + 1) * rng.integers(0, 101, (B, n, n)), torch.int32),
            t(rng.integers(-(n + 1) * 100, 1, (B, n)), torch.int32),
            t(m, torch.bool))


def clean_cold_ms(fn, cs, reps: int = 50) -> float | None:
    """Device ms per call of ``fn()`` with ``cs.L2_FLUSH_BYTES`` read
    (not written) before each call: a cold L2 with no dirty line to write
    back. None when no profiled run counts (see ``profiled_ms``)."""
    flush = torch.zeros(cs.L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda")

    def run(i):
        flush.sum()
        fn()
    run(0)
    torch.cuda.synchronize()
    return cs.profiled_ms(run, reps, "bidding_kernel", only_symbol=True)


def in_solve(launch, names, dev, cs) -> dict:
    """K4's device ms per launch in one profiled ``pallas`` solve of the
    smoke's assignment (``chip_smoke.assignment_weights``), per method and
    run, in turns (the runs in order, then in reverse), with the solver's
    ``bidding_op`` sent to each run's library (restored after). Every
    solve must give the same weights."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.assignment import cost_scaling
    w = cs.assignment_weights()
    op, out = cost_scaling.bidding_op, {}
    try:
        for method in ("auction", "pushrelabel"):
            got = out[method] = {n: [] for n in names}
            weights = set()
            for name in names + names[::-1]:
                cost_scaling.bidding_op = lambda c, p, m, name=name: launch(
                    name, c.contiguous(), p.contiguous(), m.contiguous())
                cost_scaling.solve_assignment(w[:1], method=method,
                                              backend="pallas", device=dev)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             acc_events=True) as prof:
                    res = cost_scaling.solve_assignment(
                        w, method=method, backend="pallas", device=dev)
                    torch.cuda.synchronize()
                weights.add(tuple(res.weight.tolist()))
                k4 = [r for r in cs.device_events(prof)
                      if "bidding_kernel" in r[2]]
                got[name].append(sum(r[0] for r in k4) / 1e3
                                 / sum(r[1] for r in k4))
            if len(weights) != 1:
                raise AssertionError(f"{method}: the runs' solves differ")
            print(f"[k4 variants] in the {method} pallas solve, ms per "
                  f"launch: {got}", file=sys.stderr)
    finally:
        cost_scaling.bidding_op = op
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, metavar="OTHER.cu",
                    help="a K4 source with the first design's C entry, "
                         "timed as the run 'parent'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_smoke_k4_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.bidding.kernel import _PROTOS, launch_geometry
    from repro_torch.kernels.bidding.ref import bidding_ref
    jobs = {name: build(name, subs) for name, subs in VARIANTS.items()}
    if args.parent:
        jobs["parent"] = build("parent", {}, args.parent.resolve())
    libs, regs = {}, {}
    for name, (proc, path) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(path))
        P, I = ctypes.c_void_p, ctypes.c_int
        if name == "parent":
            lib.bidding.argtypes = [P] * 6 + [I] * 3 + [P]
        else:
            for fn, argtypes in _PROTOS.items():
                getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
        regs[name] = re.findall(r"Used (\d+) registers", log)
        print(f"[k4 variants] {name}: registers {regs[name]}",
              file=sys.stderr)
    runs = {r: v for r, v in {**EXACT, **ABLATIONS}.items() if v[0] in libs}
    dev = torch.device("cuda")
    smoke = cs.k4_k5_inputs(dev)[0]
    inputs = {"8x512x512": smoke,
              "1x512x512": tuple(x[:1].contiguous() for x in smoke),
              "2x2048x2048": wide_inputs(dev)}

    def geometry(name, shape):
        """The run's library and launch at a ``(B, n_r, n_c)`` shape
        (None for the parent's own)."""
        lib_name, path = {**runs, "stamps": ("stamps", "auto")}[name]
        return libs[lib_name], (None if path is None else
                                launch_geometry(*shape, path == "auto"))

    def launch(name, c, p_y, mask):
        """One launch of a run on ``(B, n_r, n_c)`` inputs: its outputs."""
        lib, g = geometry(name, c.shape)
        B, n_r, n_c = c.shape
        outs = [torch.empty((B, n_r), dtype=torch.int32, device=dev)
                for _ in range(3)]
        ptrs = [x.data_ptr() for x in (c, p_y, mask, *outs)]
        stream = torch.cuda.current_stream().cuda_stream
        extra = () if g is None else g.c_args()
        code = lib.bidding(*ptrs, B, n_r, n_c, *extra, stream)
        if code != 0:
            raise AssertionError(f"{name}: CUDA error {code}")
        return outs

    def run(name, *a):
        """``(call, geometry)`` of a run on an input."""
        return (lambda: launch(name, *a)), geometry(name, a[0].shape)[1]

    lib = libs["stamps"]
    lib.bidding_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for key, a in inputs.items():
        want = bidding_ref(*a)
        for name in [r for r in runs if r in EXACT] + ["stamps"]:
            fn, g = run(name, *a)
            cs.compare(fn(), want, f"K4 {name} {key}")
            if name in ("kernel", "scalar"):
                print(f"[k4 variants] {key} {name}: {g}", file=sys.stderr)
        fn, g = run("stamps", *a)
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (9 * g.blocks))()
        if lib.bidding_stamps(buf, g.blocks) != 0:
            raise AssertionError("stamps: copy failed")
        s = torch.tensor(list(buf), dtype=torch.float64).view(g.blocks, 9)
        first = s[:, 0].min()
        start, end = s[:, 0] - first, s[:, 1:].amax(1) - first
        print(f"[k4 variants] stamps {key} ({g.blocks} blocks): block start "
              f"(ns after the first) median {start.median():.0f} max "
              f"{start.max():.0f}; block time median "
              f"{(end - start).median():.0f} max {(end - start).max():.0f}; "
              f"last block end {end.max():.0f}", file=sys.stderr)
    ms = {}
    for key, a in inputs.items():
        names = list(runs)
        got = ms[key] = {n: {"ms": [], "cold_ms": [], "clean_cold_ms": []}
                         for n in names}
        for name in names + names[::-1]:
            fn, _ = run(name, *a)
            got[name]["ms"].append(
                cs.time_ms(fn, symbol="bidding_kernel").ms)
            got[name]["cold_ms"].append(
                cs.time_cold_ms(fn, "bidding_kernel").ms)
            got[name]["clean_cold_ms"].append(clean_cold_ms(fn, cs))
        print(f"[k4 variants] {key} (ms warm / cold / clean cold): "
              + ", ".join(f"{n} {got[n]['ms']} / {got[n]['cold_ms']} / "
                          f"{got[n]['clean_cold_ms']}" for n in names),
              file=sys.stderr)
    solves = in_solve(launch, [r for r in ("kernel", "parent") if r in runs],
                      dev, cs)
    print(cs.nvidia_smi())
    print(json.dumps({"k4_variants_ms": ms, "in_solve_ms_per_launch": solves,
                      "registers": regs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
