"""Dry run: count every (arch × shape) step, for one H100 or per card of
the production mesh, and print its roofline row.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --all [--out results.json]
  python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape decode_32k --device cuda --batch 64
  python -m repro_torch.launch.dryrun --all --mesh 16x16 [--multi-pod]
  python -m repro_torch.launch.dryrun --arch jamba-v0.1-52b \\
      --shape long_500k --n-layers 8

Counterpart of ``repro/launch/dryrun.py``. The reference lowers and
compiles each cell on the 16 x 16 production mesh and reads XLA's memory
and cost analyses; the port builds each cell (``launch/specs.py``) on the
``meta`` device and runs it once under ``roofline_hlo.analyze``: FLOPs,
bytes, collectives and the predicted peak device memory. ``--mesh 1``
(the default) counts one card (``chips=1``); with ``--device cuda`` the
cell is built with random weights on the card and runs for real, counted
the same way. ``--mesh 16x16`` counts rank 0 of the production mesh
(``--multi-pod``: 2 x 16 x 16) on a ``fake`` process group: its shards,
its rows of the batch, its collectives by kind (``mesh`` and ``chips`` in
the row), on ``meta`` only; a mesh skips the cells one card skips.
``--n-layers`` cuts the depth. Exits 1 if any cell errs.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import dataclasses

from repro_torch.configs.base import get_config
from repro_torch.launch.specs import SHAPES, build_cell, cell_skip_reason
from repro_torch.roofline import Roofline, model_flops_for
from repro_torch.roofline_hlo import analyze

LM_ARCHS = [a for a in [
    "nemotron-4-340b", "minitron-8b", "smollm-135m", "command-r-plus-104b",
    "hubert-xlarge", "deepseek-v2-236b", "phi3.5-moe-42b-a6.6b",
    "mamba2-370m", "jamba-v0.1-52b", "chameleon-34b"]]


MESHES = ("1", "16x16", "2x16x16")


def run_cell(arch: str, shape: str, *, device: str = "meta",
             router_override=None, remat_override=None,
             microbatches: int = 1, grad_dtype: str = "f32",
             quantize_moments: bool = False, kv_quant: bool = False,
             batch: int | None = None, verbose: bool = True,
             keep_output: bool = False, mesh: str = "1",
             n_layers: int | None = None) -> dict:
    """One cell's counts and roofline row (``status`` ``ok``, ``skip`` or
    ``error``), bf16 weights. ``batch`` replaces the shape's global batch,
    ``n_layers`` the config's depth; ``mesh`` is one of ``MESHES`` (a mesh
    on ``meta`` only); with ``keep_output`` the row holds the step's
    return value (``out``) and the ``Cell`` (``cell``)."""
    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    skip = cell_skip_reason(cfg, shape)
    if skip:
        row = {"arch": arch, "shape": shape, "status": "skip",
               "reason": skip}
        return row if mesh == "1" else {**row, "mesh": mesh}
    t0 = time.time()
    try:
        from repro_torch.optim.adamw import AdamWConfig
        from repro_torch.train.step import TrainConfig
        from repro_torch.models.layers import NO_MESH, Sharder
        tcfg = TrainConfig(num_microbatches=microbatches,
                           grad_dtype=grad_dtype,
                           optimizer=AdamWConfig(
                               quantize_moments=quantize_moments))
        shd, chips = NO_MESH, 1
        if mesh != "1":
            if device != "meta":
                raise ValueError(f"--mesh {mesh} is counted on meta only")
            from repro_torch.launch.mesh import make_production_mesh
            shd = Sharder(make_production_mesh(
                multi_pod=mesh == "2x16x16"))
            chips = shd.mesh.size()
        cell = build_cell(arch, shape, device=device,
                          router_override=router_override,
                          remat_override=remat_override,
                          kv_quant=kv_quant, tcfg=tcfg, batch=batch,
                          n_layers=n_layers, shd=shd)
        acc = analyze(cell.fn, *cell.args)
        info = dict(SHAPES[shape])
        if batch is not None:
            info["global_batch"] = batch
        rl = Roofline(
            arch=arch, shape=shape, mesh=mesh, chips=chips,
            flops=acc["flops"],
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
    ap.add_argument("--mesh", default="1", choices=["1", "16x16"],
                    help="one card, or rank 0 of the production mesh")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --mesh 16x16: the 2 x 16 x 16 mesh")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in LM_ARCHS for s in SHAPES]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]

    mesh = "2x16x16" if args.multi_pod else args.mesh
    if args.multi_pod and args.mesh != "16x16":
        ap.error("--multi-pod needs --mesh 16x16")
    results = []
    for a, s in cells:
        results.append(run_cell(a, s, device=args.device,
                                router_override=args.router,
                                remat_override=args.remat,
                                microbatches=args.microbatches,
                                grad_dtype=args.grad_dtype,
                                quantize_moments=args.quantize_moments,
                                kv_quant=args.kv_quant,
                                batch=args.batch, mesh=mesh,
                                n_layers=args.n_layers))
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
