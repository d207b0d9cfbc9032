"""Serving launcher: batched prefill + greedy decode, on one card or a
mesh of ranks.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --batch 8 --prompt-len 1024 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --smoke --batch 2 --prompt-len 8 --max-new 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch phi3.5-moe-42b-a6.6b --n-layers 2 --batch 8 --prompt-len 1024
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-v2-236b --n-layers 2 --batch 8 --prompt-len 1024
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch mamba2-370m --batch 8 --prompt-len 1024 --max-new 16
  PYTHONPATH=src torchrun --nproc-per-node 3 -m repro_torch.launch.serve \\
      --arch smollm-135m --model-parallel 3 --batch 8 --prompt-len 1024
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.serve --arch smollm-135m --smoke \\
      --model-parallel 2 --batch 4 --device cpu

Counterpart of ``repro/launch/serve.py``: random weights and prompts from
``--seed`` (torch generators, so not the JAX CLI's numbers), the same
three report lines, printed by rank 0. Runs on the card unless
``--device cpu`` is given. ``--model-parallel M`` serves on a ``(world /
M, M)`` mesh (``launch.mesh.make_host_mesh``) of the ranks started by
``torchrun`` (or by ``launch.mesh.spawn`` calling ``serve``): each rank
builds the model from ``--seed``, keeps its blocks in the serving
placement (``models.model.shard_model(fsdp=False)``: split over the
model axis, whole over data, so no step gathers a weight) and serves its
rows of the batch, which must divide over the data-parallel ranks. Ranks that share a card talk
over gloo, ranks with a card each over NCCL (``launch.mesh.mesh_backend``).
One card holds a large model only with its depth cut:
``--n-layers`` keeps the config's widths and takes that many layers
(phi3.5-moe's 32 float32 layers need 168 GB; deepseek-v2's 60 about
944 GB, and its first 2 layers, the dense prefix and one MLA + MoE
layer, 21.4 GB). mamba2-370m (1.47 GB in float32) runs at full depth; a
prompt longer than its SSD chunk (256) must be a multiple of it.
jamba-v0.1's smallest legal depth, 8 layers, is 53.1 GB in float32, so
on the card it runs at ``--smoke`` width for now. The first prefill
includes building the kernels.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, smoke_variant
from repro_torch.launch.mesh import init_ranks, make_host_mesh, rank_device
from repro_torch.models.layers import NO_MESH, Sharder
from repro_torch.models.model import init_caches, init_model, shard_model
from repro_torch.serve.engine import make_prefill_step, make_serve_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse(argv)
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:   # torchrun
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_ranks(rank, world, device=args.device)
        try:
            serve(rank, world, args)
        finally:
            torch.distributed.destroy_process_group()
    else:
        serve(0, 1, args)


def serve(rank: int, world: int, args) -> None:
    """One rank's part of the run (the whole of it in one process)."""
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    if cfg.family == "encoder":
        raise SystemExit("encoder archs have no decode path")

    mesh = make_host_mesh(args.model_parallel)
    shd = NO_MESH if mesh is None else Sharder(mesh)
    dev = resolve_device(rank_device(rank, world, args.device))
    model = init_model(cfg, torch.Generator().manual_seed(args.seed),
                       device=dev)
    if mesh is not None:
        model = shard_model(model, shd, fsdp=False)
    B, S = args.batch, args.prompt_len
    prompts = torch.randint(
        0, cfg.vocab, (B, S), dtype=torch.int32,
        generator=torch.Generator().manual_seed(args.seed + 1)).to(dev)
    prompts = shd.batch_rows(prompts)
    caches = init_caches(cfg, B, S + args.max_new, dtype=torch.float32,
                         device=dev, shd=shd)

    prefill = make_prefill_step(model)
    t0 = time.perf_counter()
    nxt, state = prefill(prompts, caches)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    step = make_serve_step(model)
    toks = [nxt]
    t0 = time.perf_counter()
    for _ in range(args.max_new - 1):
        nxt, state = step(state)
        toks.append(nxt)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    out = torch.stack(toks, dim=1).cpu()
    if rank:
        return
    print(f"prefill: {B}x{S} in {t_prefill*1e3:.0f}ms "
          f"({B*S/t_prefill:.0f} tok/s)")
    print(f"decode: {args.max_new - 1} steps in {t_decode*1e3:.0f}ms "
          f"({B*(args.max_new-1)/max(t_decode,1e-9):.0f} tok/s)")
    print("sample generations (token ids):")
    for b in range(min(out.shape[0], 2)):
        print(f"  req{b}: {out[b, :12].tolist()}")


if __name__ == "__main__":
    main()
