"""Dry run: count every (arch × shape) step for one H100 and print its
roofline row.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --all [--out results.json]
  python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape decode_32k --device cuda --batch 64

Counterpart of ``repro/launch/dryrun.py``. The reference lowers and
compiles each cell on the 16 x 16 production mesh and reads XLA's memory
and cost analyses; the port builds each cell (``launch/specs.py``) on the
``meta`` device and runs it once under ``roofline_hlo.analyze``: FLOPs,
bytes, collectives and the predicted peak device memory, for one card
(``chips=1``, ``mesh=1``). With ``--device cuda`` the cell is built with
random weights on the card and runs for real, counted the same way.
There is no ``--multi-pod``: the model meshes are model parallelism,
which one card cannot hold (ROADMAP M9b.8). Exits 1 if any cell errs.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

from repro_torch.configs.base import get_config
from repro_torch.launch.specs import SHAPES, build_cell, cell_skip_reason
from repro_torch.roofline import Roofline, model_flops_for
from repro_torch.roofline_hlo import analyze

LM_ARCHS = [a for a in [
    "nemotron-4-340b", "minitron-8b", "smollm-135m", "command-r-plus-104b",
    "hubert-xlarge", "deepseek-v2-236b", "phi3.5-moe-42b-a6.6b",
    "mamba2-370m", "jamba-v0.1-52b", "chameleon-34b"]]


def run_cell(arch: str, shape: str, *, device: str = "meta",
             router_override=None, remat_override=None,
             microbatches: int = 1, grad_dtype: str = "f32",
             quantize_moments: bool = False, kv_quant: bool = False,
             batch: int | None = None, verbose: bool = True,
             keep_output: bool = False) -> dict:
    """One cell's counts and roofline row (``status`` ``ok``, ``skip`` or
    ``error``), bf16 weights. ``batch`` replaces the shape's global batch;
    with ``keep_output`` the row holds the step's return value (``out``)
    and the ``Cell`` (``cell``)."""
    cfg = get_config(arch)
    skip = cell_skip_reason(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape, "status": "skip",
                "reason": skip}
    t0 = time.time()
    try:
        from repro_torch.optim.adamw import AdamWConfig
        from repro_torch.train.step import TrainConfig
        tcfg = TrainConfig(num_microbatches=microbatches,
                           grad_dtype=grad_dtype,
                           optimizer=AdamWConfig(
                               quantize_moments=quantize_moments))
        cell = build_cell(arch, shape, device=device,
                          router_override=router_override,
                          remat_override=remat_override,
                          kv_quant=kv_quant, tcfg=tcfg, batch=batch)
        acc = analyze(cell.fn, *cell.args)
        info = dict(SHAPES[shape])
        if batch is not None:
            info["global_batch"] = batch
        rl = Roofline(
            arch=arch, shape=shape, mesh="1", chips=1, flops=acc["flops"],
            bytes_accessed=acc["bytes"], coll_bytes=acc["collective_bytes"],
            coll_breakdown=acc["collectives"],
            model_flops=model_flops_for(cfg, info),
            bytes_per_chip=acc["peak_bytes"], dtype="bf16")
        out = {
            "arch": arch, "shape": shape, "status": "ok", "device": device,
            "mesh": rl.mesh, "chips": rl.chips, "dtype": rl.dtype,
            "global_batch": info["global_batch"],
            "seq_len": info["seq_len"],
            "count_s": round(time.time() - t0, 1),
            "flops_per_chip": acc["flops"],
            "bytes_per_chip_accessed": acc["bytes"],
            "collective_bytes_per_chip": rl.coll_bytes,
            "coll_breakdown": rl.coll_breakdown,
            "bytes_per_chip": acc["peak_bytes"],
            "entry_bytes": acc["entry_bytes"],
            "t_compute_ms": rl.t_compute * 1e3,
            "t_memory_ms": rl.t_memory * 1e3,
            "t_collective_ms": rl.t_collective * 1e3,
            "t_step_ms": rl.t_step * 1e3,
            "bottleneck": rl.bottleneck,
            "model_flops": rl.model_flops,
            "useful_flops_frac": rl.useful_flops_frac,
            "roofline_frac": rl.roofline_frac,
            "k6_launches": acc["by_op"].get(
                "repro_torch.flash_attention_fwd", {}).get("count", 0),
            "note": cell.note,
        }
        if keep_output:
            out["out"], out["cell"] = acc["out"], cell
        if verbose:
            print(f"[ok] {arch}/{shape} mesh={rl.mesh} device={device} "
                  f"batch={info['global_batch']} "
                  f"flops={acc['flops']:.4g} bytes={acc['bytes']:.4g} "
                  f"mem/chip={acc['peak_bytes'] / 2**30:.2f}GiB "
                  f"t=(c{rl.t_compute*1e3:.1f}|m{rl.t_memory*1e3:.1f}|"
                  f"x{rl.t_collective*1e3:.1f})ms "
                  f"bottleneck={rl.bottleneck} "
                  f"roofline={rl.roofline_frac:.2f} "
                  f"count={out['count_s']}s", flush=True)
        return out
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        if verbose:
            traceback.print_exc()
        return {"arch": arch, "shape": shape, "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "count_s": round(time.time() - t0, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="meta",
                    help="meta (count only) or cuda (run on the card)")
    ap.add_argument("--router", default=None,
                    choices=[None, "topk", "flow"])
    ap.add_argument("--remat", default=None,
                    choices=[None, "full", "dots", "none"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-dtype", default="f32")
    ap.add_argument("--quantize-moments", action="store_true")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--batch", type=int, default=None,
                    help="rows in place of the shape's global batch")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in LM_ARCHS for s in SHAPES]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]

    results = []
    for a, s in cells:
        results.append(run_cell(a, s, device=args.device,
                                router_override=args.router,
                                remat_override=args.remat,
                                microbatches=args.microbatches,
                                grad_dtype=args.grad_dtype,
                                quantize_moments=args.quantize_moments,
                                kv_quant=args.kv_quant,
                                batch=args.batch))
        if results[-1]["status"] == "skip":
            print(f"[skip] {a}/{s}: {results[-1]['reason']}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    bad = [r for r in results if r["status"] == "error"]
    print(f"\n{len(results)} cells: "
          f"{sum(r['status']=='ok' for r in results)} ok, "
          f"{sum(r['status']=='skip' for r in results)} skip, "
          f"{len(bad)} error")
    for r in bad:
        print(f"  ERROR {r['arch']}/{r['shape']}: {r['error']}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
