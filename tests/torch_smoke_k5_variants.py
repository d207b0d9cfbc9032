"""K5 on the card: its cluster sizes against the first design, and what
its time is made of.

    python3 tests/torch_smoke_k5_variants.py [--parent OTHER.cu]

Builds ``src/repro_torch/kernels/csrc/frontier.cu`` as variants, each the
source with text substitutions, into libraries of their own (one ``nvcc``
each, all at once):

- ``kernel``: the source as it is, launched with clusters of 8 (``c8``)
  and of 16 (``c16``) blocks; ``launch_geometry`` picks one of the two
  by the grid, and the printed JSON names its pick per input;
- ``empty``: the kernel's launch with a kernel that returns at once;
- ``no_rows``: the kernel without the adjacency rows (labels, lists,
  merge);
- ``stamps``: the kernel with clock stamps of each block's phases;
- ``parent`` (with ``--parent``): ``OTHER.cu``, a K5 source with the C
  entry of the first design (a partial pass over 256-row chunks into a
  ``part`` array and a second kernel over the chunks): the way to time
  the parent commit's kernel in the same call.

Inputs: the smoke's (``chip_smoke.k4_k5_inputs``: 4 x 4096^2 at 3%, 50%
and 95% of the rows labeled), one instance of 4096^2 and a tall, narrow
1 x 20000 x 512, both half labeled (the grids that clusters of 8 leave
SMs of an H100 idle in). ``c8``, ``c16`` and ``parent`` are held bit for
bit to the plain version on each and timed L2-warm
(``chip_smoke.time_ms``) and L2-cold (``chip_smoke.time_cold_ms``) in
turns: the runs in order, then in reverse; the ablations only at the
smoke's inputs. Prints registers (``-Xptxas -v``) and the clusters the
card holds at once on stderr, each block's phase cycles from ``stamps``,
the ``nvidia-smi`` name and power limit, and one JSON line of device ms
per input, run and cache state. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

_START = "  extern __shared__ __align__(128) unsigned long long s_key[];\n"
_GT = "[&] { unsigned long long g; asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(g)); return (long long)g; }()"
_STAMPS = {
    "template <int V>\n__global__": "__device__ long long g_stamps[1024][9];\n"
                                    "template <int V>\n__global__",
    _START: _START + "  long long t0 = clock64(), t1 = t0, t2 = t0, t3 = t0, "
                     "t4 = t0, t5 = t0, t6 = t0, g0 = " + _GT + ";\n",
    "      if (lane == 0) s_count[k][warp] = __popc(bal[k]);\n    }\n"
    "    __syncthreads();\n":
    "      if (lane == 0) s_count[k][warp] = __popc(bal[k]);\n    }\n"
    "    __syncthreads();\n    if (r0 == row_lo) t1 = clock64();\n",
    "    stage(r0 + kChunk);   // in flight while this chunk's rows stream\n"
    "    __syncthreads();\n":
    "    stage(r0 + kChunk);   // in flight while this chunk's rows stream\n"
    "    __syncthreads();\n    t2 = clock64();\n",
    "  asm volatile(\"barrier.cluster.wait.aligned;\" ::: \"memory\");\n":
    "  t4 = clock64();\n"
    "  asm volatile(\"barrier.cluster.wait.aligned;\" ::: \"memory\");\n"
    "  t5 = clock64();\n",
    "  cluster.sync();      // every block's minima have arrived; none is "
    "read\n":
    "  t6 = clock64();\n  cluster.sync();\n  t3 = clock64();\n",
    "        claim[out] = static_cast<int>(m & 0xffffffffu);\n      }\n"
    "    }\n  }\n}\n":
    "        claim[out] = static_cast<int>(m & 0xffffffffu);\n      }\n"
    "    }\n  }\n  if (tid == 0) {\n"
    "    long long* s = g_stamps[blockIdx.y * gridDim.x + blockIdx.x];\n"
    "    s[0] = g0; s[1] = " + _GT + "; s[2] = t1 - t0; s[3] = t2 - t1;\n"
    "    s[4] = t4 - t2; s[5] = t5 - t4; s[6] = t6 - t5; s[7] = t3 - t6;\n"
    "    s[8] = clock64() - t3;\n  }\n}\n",
}
_STAMPS_GET = """
extern "C" int frontier_stamps(long long* out, int blocks) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_stamps, sizeof(long long) * 9 * blocks));
}
"""
# the phases of a block that ``stamps`` times (cycles of its thread 0)
PHASES = ("labels", "list", "rows", "wait", "push", "sync", "out")
# name: text substitutions
VARIANTS = {
    "kernel": {},
    "empty": {_START: _START + "  if (n_r > 0) return;\n"},
    "no_rows": {"    if (c0 < n_c) {": "    if (c0 < 0) {"},
    "stamps": _STAMPS,
}
# run: (library, blocks per cluster); the runs that compute the function
EXACT = {"c8": ("kernel", 8), "c16": ("kernel", 16), "parent": ("parent", 0)}
ABLATIONS = {"empty": ("empty", 8), "no_rows": ("no_rows", 8)}
STAMPS = {"stamps": ("stamps", 8)}


def build(name: str, subs: dict, src: pathlib.Path | None = None):
    """Start ``nvcc`` on the source with ``subs`` applied (``src``, the
    parent's source, as it is)."""
    from repro_torch.kernels import _build
    out_dir = _build.BUILD_DIR / "k5_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = src or out_dir / f"{name}.cu"
    if src is None:
        text = (_build.CSRC / "frontier.cu").read_text()
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


def extra_inputs(dev):
    """One instance of 4096^2 and a 1 x 20000 x 512, half the rows
    labeled, at the smoke graphs' density of 4 edges a row."""
    from repro_torch.kernels.frontier.ref import INF
    rng = np.random.default_rng(7)
    out = {}
    for B, n_r, n_c in ((1, 4096, 4096), (1, 20000, 512)):
        t = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa
        adj = torch.tensor(rng.random((B, n_r, n_c)) < 4 / n_c, device=dev)
        root = np.where(rng.random((B, n_r)) < 0.5,
                        rng.integers(0, n_r, (B, n_r)), INF)
        out[f"{B}x{n_r}x{n_c} 50%"] = (adj, t(root),
                                       t(rng.integers(-1, n_c, (B, n_r))))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, metavar="OTHER.cu",
                    help="a K5 source with the first design's C entry, "
                         "timed as the run 'parent'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_smoke_k5_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.frontier.kernel import _PROTOS, launch_geometry
    from repro_torch.kernels.frontier.ref import frontier_ref
    jobs = {name: build(name, subs) for name, subs in VARIANTS.items()}
    if args.parent:
        jobs["parent"] = build("parent", {}, args.parent.resolve())
    libs = {}
    for name, (proc, path) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(path))
        P, I = ctypes.c_void_p, ctypes.c_int
        if name == "parent":
            lib.frontier.argtypes = [P] * 6 + [I] * 4 + [P]
            lib.frontier_chunk_rows.argtypes = []
        else:
            for fn, argtypes in _PROTOS.items():
                getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
        used = re.findall(r"Used (\d+) registers.*?(\d+) bytes smem", log)
        print(f"[k5 variants] {name}: registers and static shared memory "
              f"per kernel {used}", file=sys.stderr)
    exact = {r: v for r, v in EXACT.items() if v[0] in libs}
    dev = torch.device("cuda")
    _, smoke = cs.k4_k5_inputs(dev)
    inputs = {f"4x4096x4096 {s:.0%}": a for s, a in smoke.items()}
    inputs.update(extra_inputs(dev))

    def run(name, adj, root, match):
        lib_name, cluster = {**exact, **ABLATIONS, **STAMPS}[name]
        lib = libs[lib_name]
        B, n_r, n_c = adj.shape
        g = launch_geometry(B, n_r, n_c, n_c % 16 == 0, cluster or None)

        def call():
            min_root, claim = (torch.empty((B, n_c), dtype=torch.int32,
                                           device=dev) for _ in range(2))
            stream = torch.cuda.current_stream().cuda_stream
            ptrs = [x.data_ptr() for x in (adj, root, match)]
            outs = [min_root.data_ptr(), claim.data_ptr()]
            if lib_name == "parent":
                n_chunks = math.ceil(n_r / lib.frontier_chunk_rows())
                part = torch.empty((B, n_chunks, n_c), dtype=torch.int64,
                                   device=dev)
                code = lib.frontier(*ptrs, part.data_ptr(), *outs, B, n_r,
                                    n_c, n_chunks, stream)
            else:
                code = lib.frontier(*ptrs, *outs, B, n_r, n_c, *g.c_args(),
                                    stream)
            if code != 0:
                raise AssertionError(f"{name}: CUDA error {code}")
            return min_root, claim
        return call, g

    picks = {}
    for key, a in inputs.items():
        want = frontier_ref(*a)
        B, n_r, n_c = a[0].shape
        picks[key] = launch_geometry(B, n_r, n_c, n_c % 16 == 0).cluster
        for name in exact:
            fn, g = run(name, *a)
            cs.compare(fn(), want, f"K5 {name} {key}")
            if name != "parent":
                held = ctypes.c_int(0)
                if libs["kernel"].frontier_max_active_clusters(
                        g.vec, g.cluster, g.smem_bytes, *g.grid,
                        ctypes.byref(held)) != 0:
                    raise AssertionError(f"{name}: occupancy query failed")
                print(f"[k5 variants] {key} {name}: {g}; the card holds "
                      f"{held.value} clusters at once, the grid has "
                      f"{g.grid[0] * g.grid[1] // g.cluster}",
                      file=sys.stderr)
    lib = libs["stamps"]
    lib.frontier_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for share, a in smoke.items():
        fn, g = run("stamps", *a)
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        n = g.grid[0] * g.grid[1]
        buf = (ctypes.c_longlong * (9 * n))()
        if lib.frontier_stamps(buf, n) != 0:
            raise AssertionError("stamps: copy failed")
        s = torch.tensor(list(buf), dtype=torch.float64).view(n, 9)
        start, end = s[:, 0] - s[:, 0].min(), s[:, 1] - s[:, 0].min()
        print(f"[k5 variants] stamps {share:.0%}: block start (ns after the "
              f"first) median {start.median():.0f} max {start.max():.0f}; "
              f"block end median {end.median():.0f} max {end.max():.0f}; "
              f"cycles per phase (median / max) "
              + ", ".join(f"{p} {s[:, 2 + k].median():.0f} / "
                          f"{s[:, 2 + k].max():.0f}"
                          for k, p in enumerate(PHASES)),
              file=sys.stderr)
    ms = {}
    for key, a in inputs.items():
        names = list(exact) + (list(ABLATIONS) if key.startswith("4x")
                               else [])
        got = ms[key] = {n: {"ms": [], "cold_ms": []} for n in names}
        for name in names + names[::-1]:
            fn, _ = run(name, *a)
            got[name]["ms"].append(cs.time_ms(fn, symbol="frontier_").ms)
            got[name]["cold_ms"].append(
                cs.time_cold_ms(fn, "frontier_").ms)
        got["launch_geometry_cluster"] = picks[key]
        print(f"[k5 variants] {key}: " + ", ".join(
            f"{n} {got[n]['ms']} / {got[n]['cold_ms']}" for n in names),
            file=sys.stderr)
    print(cs.nvidia_smi())
    print(json.dumps({"k5_variants_ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
