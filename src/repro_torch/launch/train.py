"""Training launcher: data -> train step -> checkpoint / restart, one card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 200 --batch 8 --seq 1024 --ckpt-dir /tmp/run1 --resume auto
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --smoke --batch 2 --seq 32 --steps 4 --device cpu

Counterpart of ``repro/launch/train.py``: its arguments and report lines
(``step N: loss=...``, ``[ckpt]``, ``[resume] restored step N``,
``[preempt]``, ``[watchdog]``), random weights from ``--seed`` (a torch
generator, so not the JAX CLI's numbers), the data pipeline's rows from
``--seed``. Runs on the card unless ``--device cpu`` is given. One card
has no mesh: ``--model-parallel`` other than 1 raises (ROADMAP M9b.8).
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

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import store
from repro_torch.configs.base import get_config, smoke_variant
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models.model import init_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.ft import PreemptionGuard, StepWatchdog
from repro_torch.train.step import (TrainConfig, init_train_state,
                                    load_state_tree, make_train_step,
                                    state_tree)


def main(argv=None) -> None:
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
    args = ap.parse_args(argv)

    if args.model_parallel != 1:
        raise SystemExit("--model-parallel: the port trains on one card "
                         "(its dry run, ROADMAP M9b.7, counts one card); "
                         "sharding a model over cards is ROADMAP M9b.8")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    if args.router and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, router=args.router))

    dev = resolve_device(args.device)
    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr_peak=args.lr, warmup_steps=20,
                              decay_steps=args.steps,
                              quantize_moments=args.quantize_moments),
        num_microbatches=args.microbatches, grad_dtype=args.grad_dtype)
    model = init_model(cfg, torch.Generator().manual_seed(args.seed),
                       device=dev)
    state = init_train_state(cfg, tcfg, model)

    start_step = 0
    if args.resume == "auto" and args.ckpt_dir:
        latest = store.latest_step(args.ckpt_dir)
        if latest is not None:
            state = load_state_tree(state, store.restore(
                args.ckpt_dir, latest, state_tree(state), device=dev))
            start_step = latest
            print(f"[resume] restored step {latest} from {args.ckpt_dir}")

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed,
                      frontend_dim=cfg.frontend_dim)
    step_fn = make_train_step(cfg, tcfg)
    watchdog = StepWatchdog()
    with PreemptionGuard() as guard:
        for step in range(start_step, args.steps):
            batch = make_batch(dcfg, step, dev)
            watchdog.start()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])       # waits for the step
            slow = watchdog.stop(step)
            if step % 10 == 0 or step == args.steps - 1:
                print(f"step {step}: loss={loss:.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):.2f} "
                      f"t={watchdog.times[-1]*1e3:.0f}ms"
                      + (" [STRAGGLER]" if slow else ""))
            want_ckpt = args.ckpt_dir and (
                (step + 1) % args.ckpt_every == 0 or guard.requested
                or step == args.steps - 1)
            if want_ckpt:
                path = store.save(args.ckpt_dir, step + 1, state_tree(state))
                print(f"[ckpt] step {step + 1} -> {path}")
            if guard.requested:
                print("[preempt] checkpoint written, exiting cleanly")
                return
    if watchdog.slow_steps:
        print(f"[watchdog] {len(watchdog.slow_steps)} straggler steps "
              f"(median {watchdog.median*1e3:.0f}ms)")


if __name__ == "__main__":
    main()
