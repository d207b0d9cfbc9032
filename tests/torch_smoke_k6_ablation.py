"""K6 ablations on the card: what the float32 kernel's time is made of.

    python3 tests/torch_smoke_k6_ablation.py [--parent OTHER.cu]

Builds variants of ``src/repro_torch/kernels/csrc/flash_attention.cu``
(whose serve-shape kernel is ``flash_fwd_wgmma``), each the source with
text substitutions, into libraries of their own (one ``nvcc`` each, all
at once). Each is checked at the serve prefill's shape (8 x 1024 tokens,
9 heads over 3 kv heads, dh = dv = 64, causal, float32) and at one key
tile (128 queries, 64 keys), and timed at the serve shape with
``chip_smoke.time_ms``, in turns: the variants in order, then in reverse.

- ``kernel``: the source as it is, held to the plain version (3e-5);
- ``cvt``: TF32 rounding by ``cvt.rna.tf32.f32`` instead of the two
  integer ops (the same bits: held to 3e-5 as well);
- ``no_split``: operands passed unsplit (hi = x, lo = 0; plain TF32,
  about 3e-3 off); the three products still run;
- ``no_products``: no product at all (scores 0): the work around them;
- ``pv_hi``: the PV product as hi*hi alone. ptxas then gives registers
  that hold q's split fragments (read by every key tile's q k^T) to the
  softmax inside the key loop, so from the second key tile on the scores
  are wrong (source note in the ``.cu``);
- ``parent`` (with ``--parent``): ``OTHER.cu``, a K6 source with the C
  entry of the first (FFMA) design, which takes no geometry: the way to
  time the parent commit's kernel in the same call.

For each ``flash_fwd_wgmma`` it also counts the registers of q's split
fragments (A operands of the q k^T ``wgmma``) that the key loop
overwrites and does not restore before the next tile (``cuobjdump
-sass``): 0 in a correct build. Prints registers (``-Xptxas -v``),
errors and that count on stderr, the ``nvidia-smi``
name and power limit, and one JSON line of device ms per variant. Exits 1
without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

_SPLIT = ("  hi = tf32(x);\n  lo = tf32(x - __uint_as_float(hi));")
_TF32 = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
_QK = "      wgmma_3xtf32(S, qhi, qlo, khi, klo, false);"
_PV = "      wgmma_3xtf32(acc, phi, plo, vhi, vlo, true);"
_KERNEL = "__global__ void __launch_bounds__(kWgThreads) flash_fwd_wgmma("
_HI_ONLY = """__device__ __forceinline__ void wgmma_hi(float (&d)[32],
                                         uint32_t (&a)[8][4],
                                         const float* b) {
  fence_acc(d);
  fence_frag(a);
  asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < 8; ++s) wgmma_tf32(d, a[s], gmma_desc(b + 64 * s, 128, 2048), 1);
  asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
  fence_acc(d);
  fence_frag(a);
}

"""
VARIANTS = {
    "kernel": {},
    "cvt": {_TF32: '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : '
                   '"=r"(r) : "f"(x));\n  return r & 0xffffe000u;'},
    "no_split": {_SPLIT: "  hi = __float_as_uint(x);\n  lo = 0u;"},
    "no_products": {_QK: "      for (int i = 0; i < 32; ++i) S[i] = 0.f;",
                    _PV: ""},
    "pv_hi": {_KERNEL: _HI_ONLY + _KERNEL,
              _PV: "      wgmma_hi(acc, phi, vhi);"},
}
EXACT = ("kernel", "cvt", "parent")   # variants held to the plain version
SERVE = (8, 1024, 1024, 9, 3, 64, 64)
ONE_TILE = (1, 128, 64, 1, 1, 64, 64)


def build(name: str, subs: dict, src: pathlib.Path | None = None):
    """Start ``nvcc`` on the source with ``subs`` applied (``src``, the
    parent's source, as it is)."""
    from repro_torch.kernels import _build
    out_dir = _build.BUILD_DIR / "k6_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = src or out_dir / f"{name}.cu"
    if src is None:
        text = (_build.CSRC / "flash_attention.cu").read_text()
        for old, new in subs.items():
            if text.count(old) != 1:
                raise AssertionError(f"{name}: the source holds {old!r} "
                                     f"{text.count(old)} times, not once")
            text = text.replace(old, new)
        path.write_text(text)
    lib = out_dir / f"lib{name}.so"
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(_build.CSRC), "-o", str(lib), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def q_fragments_lost(lib: pathlib.Path) -> int:
    """Registers of q's split fragments (the A operands of the first 24
    ``HGMMA`` of ``flash_fwd_wgmma``'s key loop: q k^T, 8 k8 steps of three
    products) that an instruction overwrites after q k^T and none restores
    before the next key tile's q k^T; 0 in a correct build, -1 without
    that kernel or its products."""
    from repro_torch.kernels import _build
    cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    start = sass.find("flash_fwd_wgmma")
    ins = [(int(a, 16), s.strip()) for a, s in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);",
        sass[start:sass.find("Function :", start)])]
    qk = [(a, s) for a, s in ins if s.startswith("HGMMA")][:24]
    if start < 0 or len(qk) < 24:
        return -1
    a_regs = set()
    for _, s in qk:
        first = int(re.match(r"HGMMA\.\S+\s+R\d+,\s*R(\d+),", s).group(1))
        a_regs |= {f"R{first + i}" for i in range(4)}
    loops = [(int(m.group(1), 16), a) for a, s in ins
             for m in [re.search(r"BRA\s+0x([0-9a-f]+)", s)]
             if m and int(m.group(1), 16) <= qk[0][0] <= a]
    lo, hi = min(loops, key=lambda lp: lp[1] - lp[0])
    before, after = set(), set()
    for a, s in ins:
        m = re.match(r"(?:@!?P\w+\s+)?([A-Z][A-Z0-9.]*)\s+R(\d+)\b", s)
        if not m or m.group(1).startswith(("HGMMA", "ST")):
            continue
        op, r = m.group(1), int(m.group(2))   # .64 / CS2R: two, .128: four
        wide = 4 if ".128" in op else 2 if ".64" in op or op == "CS2R" else 1
        written = {f"R{r + i}" for i in range(wide)} & a_regs
        if lo <= a < qk[0][0]:
            before |= written
        elif qk[-1][0] < a <= hi:
            after |= written
    return len(after - before)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, metavar="OTHER.cu",
                    help="a K6 source with the first design's C entry, "
                         "timed as the variant 'parent'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_smoke_k6_ablation: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    import chip_smoke as cs
    from repro_torch.kernels.flash_attention.kernel import (
        _PROTOS, launch_geometry)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    jobs = {name: build(name, subs) for name, subs in VARIANTS.items()}
    if args.parent:
        jobs["parent"] = build("parent", {}, args.parent.resolve())
    libs = {}
    for name, (proc, path) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(path))
        protos = _PROTOS["flash_attention_fwd"]
        lib.flash_attention_fwd.argtypes = (   # the first design: no lse,
            protos[:4] + protos[5:-2] + protos[-1:]   # no geometry
            if name == "parent" else protos)
        libs[name] = lib
        regs = re.findall(r"Used (\d+) registers", log)
        print(f"[ablation] {name}: registers of its kernels {regs}; "
              f"q fragment registers lost in the key loop: "
              f"{q_fragments_lost(path)}", file=sys.stderr)
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED + 2)
    inputs = {dims: cs.flash_inputs(rng, dims, torch.float32, dev)
              for dims in (SERVE, ONE_TILE)}

    def run(name, dims):
        B, Sq, Sk, H, KV, dh, dv = dims
        q, k, v = inputs[dims]
        geo = launch_geometry(B, Sq, H, dh, dv).c_args()
        extra = () if name == "parent" else ((ctypes.c_int * 11)(*geo),)
        lse = () if name == "parent" else (None,)   # no lse output

        def call():
            o = torch.empty((B, Sq, H, dv), device=dev)
            code = libs[name].flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                *lse, B, Sq, Sk, H, KV, dh, dv, 0, dh ** -0.5, 1, *extra,
                torch.cuda.current_stream().cuda_stream)
            if code != 0:
                raise AssertionError(f"{name}: CUDA error {code}")
            return o
        return call
    for dims in inputs:
        want = flash_attention_ref(*inputs[dims], causal=True)
        for name in libs:
            err = (run(name, dims)() - want).abs().max().item()
            print(f"[ablation] {name} {dims}: max abs err {err:.3g}",
                  file=sys.stderr)
            if name in EXACT and not err <= cs.FLASH_TOL[torch.float32]:
                raise AssertionError(f"{name} {dims}: max abs err {err}")
    ms = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        ms[name].append(cs.time_ms(run(name, SERVE)).ms)
    print(cs.nvidia_smi())
    print(json.dumps({"k6_ablation_ms": ms, "dims": list(SERVE)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
