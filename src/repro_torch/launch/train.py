"""Training launcher: data -> train step -> checkpoint / restart, on one
card or a mesh of ranks.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 200 --batch 8 --seq 1024 --ckpt-dir /tmp/run1 --resume auto
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --smoke --batch 2 --seq 32 --steps 4 --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 6 -m repro_torch.launch.train \\
      --arch smollm-135m --model-parallel 3 --batch 8 --seq 1024
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.train --arch smollm-135m --smoke \\
      --model-parallel 2 --batch 2 --seq 32 --device cpu

Counterpart of ``repro/launch/train.py``: its arguments and report lines
(``step N: loss=...``, ``[ckpt]``, ``[resume] restored step N``,
``[preempt]``, ``[watchdog]``), random weights from ``--seed`` (a torch
generator, so not the JAX CLI's numbers), the data pipeline's rows from
``--seed``. Runs on the card unless ``--device cpu`` is given.
``--model-parallel M`` trains on a ``(world / M, M)`` mesh
(``launch.mesh.make_host_mesh``, which refuses an M that does not divide
the ranks) of the ranks started by ``torchrun`` (or by
``launch.mesh.spawn`` calling ``train``): each rank keeps its blocks of
the model (``models.model.shard_model``) and trains on its rows of every
batch, the AdamW moments whole on every rank (the reference's ``P()``);
rank 0 prints and writes the checkpoints, each whole
(``train.step.state_tree``), so a run resumes on any mesh or on one card.
The step follows the config's ``remat``, as the reference's does.
``--n-layers`` keeps the config's widths and takes that many layers, as
in ``launch/serve.py``. The train state (parameters, moments, step) is
saved and restored through ``checkpoint/store.py``; a resumed run goes on
with the same data rows and gives the same parameters, bit for bit, as
one that never stopped (on the CPU; the card's sums may vary run to
run). An encoder (``--arch hubert-xlarge``) trains on the pipeline's
``embeds`` rows: frame embeddings of ``frontend_dim`` and their labels.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import store
from repro_torch.configs.base import get_config, smoke_variant
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch.mesh import init_ranks, make_host_mesh, rank_device
from repro_torch.models.layers import NO_MESH, Sharder
from repro_torch.models.model import init_model, shard_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.ft import PreemptionGuard, StepWatchdog
from repro_torch.train.step import (TrainConfig, init_train_state,
                                    load_state_tree, make_train_step,
                                    state_like, state_tree)


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="none", choices=["none", "auto"])
    ap.add_argument("--router", default=None)
    ap.add_argument("--grad-dtype", default="f32")
    ap.add_argument("--quantize-moments", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse(argv)
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:   # torchrun
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_ranks(rank, world, device=args.device)
        try:
            train(rank, world, args)
        finally:
            torch.distributed.destroy_process_group()
    else:
        train(0, 1, args)


def train(rank: int, world: int, args) -> None:
    """One rank's part of the run (the whole of it in one process)."""
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    if args.router and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, router=args.router))

    mesh = make_host_mesh(args.model_parallel)
    shd = NO_MESH if mesh is None else Sharder(mesh)
    dev = resolve_device(rank_device(rank, world, args.device))
    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr_peak=args.lr, warmup_steps=20,
                              decay_steps=args.steps,
                              quantize_moments=args.quantize_moments),
        num_microbatches=args.microbatches, grad_dtype=args.grad_dtype)
    model = init_model(cfg, torch.Generator().manual_seed(args.seed),
                       device=dev)
    if mesh is not None:
        model = shard_model(model, shd)
    state = init_train_state(cfg, tcfg, model)

    start_step = 0
    if args.resume == "auto" and args.ckpt_dir:
        latest = store.latest_step(args.ckpt_dir)
        if latest is not None:
            state = load_state_tree(state, store.restore(
                args.ckpt_dir, latest, state_like(state), device=dev))
            start_step = latest
            say(f"[resume] restored step {latest} from {args.ckpt_dir}")

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed,
                      frontend_dim=cfg.frontend_dim)
    step_fn = make_train_step(cfg, tcfg)
    watchdog = StepWatchdog()
    with PreemptionGuard() as guard:
        for step in range(start_step, args.steps):
            batch = {k: shd.batch_rows(x)
                     for k, x in make_batch(dcfg, step, dev).items()}
            watchdog.start()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])       # waits for the step
            slow = watchdog.stop(step)
            if step % 10 == 0 or step == args.steps - 1:
                say(f"step {step}: loss={loss:.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):.2f} "
                      f"t={watchdog.times[-1]*1e3:.0f}ms"
                      + (" [STRAGGLER]" if slow else ""))
            # every rank stops where any was asked to
            stop = guard.requested if mesh is None else bool(shd.reduce_all(
                torch.tensor(float(guard.requested), device=dev)) > 0)
            want_ckpt = args.ckpt_dir and (
                (step + 1) % args.ckpt_every == 0 or stop
                or step == args.steps - 1)
            if want_ckpt:
                tree = state_tree(state)        # whole: every rank gathers
                if rank == 0:
                    path = store.save(args.ckpt_dir, step + 1, tree)
                    say(f"[ckpt] step {step + 1} -> {path}")
                shd.barrier()
            if stop:
                say("[preempt] checkpoint written, exiting cleanly")
                return
    if watchdog.slow_steps:
        say(f"[watchdog] {len(watchdog.slow_steps)} straggler steps "
              f"(median {watchdog.median*1e3:.0f}ms)")


if __name__ == "__main__":
    main()
