"""The ranks' side of ``tests/test_torch_model_mesh.py``: the port's
serve, train, forward and resume paths on meshes of CPU ranks over gloo.

``run(rank, world, out)`` (through ``repro_torch.launch.mesh.spawn``)
builds every mesh of ``MESHES`` on the 4 ranks, then runs each case of
``CASES`` on the ranks of its mesh and saves what it got to ``out`` as
``{case}.{rank}.pt``. Inputs come from seeds (``numpy_params``, numpy
prompts, the data pipeline's rows), so the test builds the same ones for
the JAX package. Imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

WORLD = 4
# name -> the ranks' grid (data x model)
MESHES = {"1x2": [[0, 1]], "2x1": [[0], [1]], "2x2": [[0, 1], [2, 3]],
          "1x4": [[0, 1, 2, 3]]}
B, S, NEW = 4, 16, 4
TRAIN_B, TRAIN_S = 4, 32


def replaced(cfg, over: dict):
    """``cfg`` (either package's) with ``over`` replaced; a dict replaces
    fields of the nested config it names (``{"ssm": {"expand": 3}}``)."""
    return dataclasses.replace(cfg, **{
        k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
        else v for k, v in over.items()})


def config(arch: str, **over):
    """The smoke variant of ``arch`` with ``over`` replaced (an MoE routes
    with the paper's auction)."""
    from repro_torch.configs.base import get_config, smoke_variant
    cfg = smoke_variant(get_config(arch))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, router="flow"))
    return replaced(cfg, over)


# case -> (kind, mesh, arch, config overrides, extra)
CASES = {
    "smollm_serve_1x2": ("serve", "1x2", "smollm-135m", {}, {}),
    "smollm_serve_2x1": ("serve", "2x1", "smollm-135m", {}, {}),
    "smollm_serve_2x2": ("serve", "2x2", "smollm-135m", {}, {}),
    # S_max = 21: the caches' sequence is whole on every rank
    "smollm_serve_2x2_whole_cache": ("serve", "2x2", "smollm-135m", {},
                                     {"S_max": S + NEW + 1}),
    # the serving placement: weights whole over data, no step gathers them
    "smollm_serve_2x2_fsdp_off": ("serve", "2x2", "smollm-135m", {},
                                  {"fsdp": False}),
    "smollm_kvq_serve_1x2": ("serve", "1x2", "smollm-135m",
                             {"kv_quant": True}, {}),
    "smollm_train_1x2": ("train", "1x2", "smollm-135m", {}, {}),
    "smollm_train_2x1": ("train", "2x1", "smollm-135m", {}, {}),
    "smollm_train_2x2": ("train", "2x2", "smollm-135m", {}, {}),
    "phi_serve_2x1": ("serve", "2x1", "phi3.5-moe-42b-a6.6b", {}, {}),
    "phi_serve_2x2": ("serve", "2x2", "phi3.5-moe-42b-a6.6b", {}, {}),
    "phi_train_2x2": ("train", "2x2", "phi3.5-moe-42b-a6.6b", {}, {}),
    "hubert_forward_1x2": ("forward", "1x2", "hubert-xlarge", {}, {}),
    # 6 heads over 4 ranks: every rank runs every head
    "heads_serve_1x4": ("serve", "1x4", "smollm-135m",
                        {"n_heads": 6, "n_kv_heads": 2}, {}),
    "heads_train_1x4": ("train", "1x4", "smollm-135m",
                        {"n_heads": 6, "n_kv_heads": 2}, {}),
    # 4 heads over 2 kv heads on 4 ranks: 1 q head a rank, the kv head of
    # its group taken from the whole keys and values
    "kv_groups_serve_1x4": ("serve", "1x4", "smollm-135m", {}, {}),
    "kv_groups_train_1x4": ("train", "1x4", "smollm-135m", {}, {}),
    "resume_1x2": ("resume", "1x2", "smollm-135m", {}, {}),
    # int8 moments: wo's (64, 64) and its (64, 32) block both quantize to
    # (64, 1, 256), so only the state's own record tells them apart
    "resume_q_1x2": ("resume", "1x2", "smollm-135m", {},
                     {"quantize": True}),
    # a batch of 3 rows does not split over 2 data ranks: each takes it all
    "smollm_train_2x1_batch3": ("train", "2x1", "smollm-135m", {},
                                {"batch": 3}),
    # MLA (deepseek-v2's smoke variant: 4 heads, a dense first layer, then
    # 4 routed experts and 2 shared): 2 heads a rank and S_max = 20 split
    # over the model axis (the absorbed decode's flash-decoding combine)
    "deepseek_serve_1x2": ("serve", "1x2", "deepseek-v2-236b", {}, {}),
    "deepseek_serve_1x4": ("serve", "1x4", "deepseek-v2-236b", {}, {}),
    "deepseek_serve_2x2_whole_cache": ("serve", "2x2", "deepseek-v2-236b",
                                       {}, {"S_max": S + NEW + 1}),
    "deepseek_train_1x2": ("train", "1x2", "deepseek-v2-236b", {}, {}),
    # 6 heads over 4 ranks: every rank runs every head, on queries gathered
    # from its block of wq_b's 192 columns, and its block of wo's 96 rows
    "mla_heads_serve_1x4": ("serve", "1x4", "deepseek-v2-236b",
                            {"n_heads": 6, "n_kv_heads": 6}, {}),
    "mla_heads_train_1x4": ("train", "1x4", "deepseek-v2-236b",
                            {"n_heads": 6, "n_kv_heads": 6}, {}),
    # Mamba2 (8 heads of 32): 4 and 2 heads a rank
    "mamba_serve_1x2": ("serve", "1x2", "mamba2-370m", {}, {}),
    "mamba_serve_1x4": ("serve", "1x4", "mamba2-370m", {}, {}),
    "mamba_train_1x2": ("train", "1x2", "mamba2-370m", {}, {}),
    # 6 heads of 64 (expand 3) over 4 ranks: every rank runs every head;
    # in_proj's 806 columns whole, the conv's 416 channels and di's 384
    # split
    "ssm_heads_serve_1x4": ("serve", "1x4", "mamba2-370m",
                            {"ssm": {"head_dim": 64, "expand": 3}}, {}),
    "ssm_heads_train_1x4": ("train", "1x4", "mamba2-370m",
                            {"ssm": {"head_dim": 64, "expand": 3}}, {}),
    # the hybrid: GQA, Mamba2 and the MoE on 2 x 2
    "jamba_serve_2x2": ("serve", "2x2", "jamba-v0.1-52b", {}, {}),
    "collectives_2x2": ("collectives", "2x2", None, {}, {}),
}


def torchrun(module: str, nproc: int, args: list,
             timeout: float = 300) -> subprocess.CompletedProcess:
    """``torchrun --standalone --nproc-per-node nproc -m module *args`` on
    the CPU (a free localhost port of torchrun's choosing), its output
    captured."""
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "OMP_NUM_THREADS": "2",
           "PYTHONPATH": os.pathsep.join(
               [src, *filter(None, [os.environ.get("PYTHONPATH")])])}
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", module, *args],
        env=env, capture_output=True, text=True, timeout=timeout)


def prompts(vocab: int) -> np.ndarray:
    return np.random.default_rng(1).integers(0, vocab, (B, S),
                                             dtype=np.int32)


def train_batch(cfg, step: int, rows: int = TRAIN_B) -> dict:
    """The data pipeline's ``rows`` rows of ``step`` (numpy)."""
    from repro_torch.data.pipeline import DataConfig, rows_batch
    return rows_batch(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                 global_batch=rows,
                                 frontend_dim=cfg.frontend_dim),
                      step, 0, rows)


def frames(cfg) -> np.ndarray:
    return np.random.default_rng(2).standard_normal(
        (B, S, cfg.frontend_dim), dtype=np.float32)


def train_config(quantize: bool = False):
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import TrainConfig
    return TrainConfig(optimizer=AdamWConfig(
        warmup_steps=2, decay_steps=10, quantize_moments=quantize))


def one_card_dir(extra) -> str:
    """The directory (under the test's) of the one-card checkpoint a
    resume case starts from."""
    return "one_q" if extra.get("quantize") else "one"


@contextlib.contextmanager
def record_routing():
    """Every router call of ``models.mlp``: ``(scores, dispatch)``."""
    from repro_torch.models import mlp
    seen = []
    originals = {n: getattr(mlp, n) for n in ("auction_route", "topk_route")}

    def spy(name):
        def route(scores, k, capacity, **kw):
            r = originals[name](scores, k, capacity, **kw)
            seen.append((name, capacity, scores.clone(), r.dispatch.clone()))
            return r
        return route
    try:
        for name in originals:
            setattr(mlp, name, spy(name))
        yield seen
    finally:
        for name, fn in originals.items():
            setattr(mlp, name, fn)


def placed(cfg, shd, fsdp: bool = True):
    from repro_torch.interop import model_from_params, numpy_params
    from repro_torch.models.model import shard_model
    return shard_model(model_from_params(cfg, numpy_params(cfg, 0), "cpu"),
                       shd, fsdp=fsdp)


def serve(cfg, shd, extra) -> dict:
    from repro_torch.models.model import init_caches
    from repro_torch.serve.engine import make_prefill_step, make_serve_step
    model = placed(cfg, shd, extra.get("fsdp", True))
    caches = init_caches(cfg, B, extra.get("S_max", S + NEW),
                         dtype=torch.float32, device="cpu", shd=shd)
    with record_routing() as seen:
        nxt, st = make_prefill_step(model)(
            shd.batch_rows(torch.tensor(prompts(cfg.vocab))), caches)
        logits = [st.logits]
        step = make_serve_step(model)
        for _ in range(NEW - 1):
            nxt, st = step(st)
            logits.append(st.logits)
    return {"logits": torch.stack(logits, 1), "routing": seen,
            "seq_split": getattr(caches[0][0], "spec", (None, None))[1]}


def whole_grads(model, grads: dict) -> dict:
    shd = model.shd
    return {n: shd.unshard(g, p.spec)
            for (n, p), g in zip(model.named_parameters(), grads.values())}


def train(cfg, shd, extra) -> dict:
    from repro_torch.train import step as tstep
    model = placed(cfg, shd)
    n = extra.get("batch", TRAIN_B)
    rows = {k: shd.batch_rows(torch.tensor(x))
            for k, x in train_batch(cfg, 0, n).items()}
    loss, aux = tstep.loss_fn(model, rows)
    ps = tstep.params_of(model)
    grads = dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))
    out = {"loss0": aux["loss"], "tokens": aux["tokens"],
           "grads": whole_grads(model, grads), "steps": []}
    tcfg = train_config()
    state = tstep.init_train_state(cfg, tcfg, model)
    fn = tstep.make_train_step(cfg, tcfg)
    for step in range(2):
        rows = {k: shd.batch_rows(torch.tensor(x))
                for k, x in train_batch(cfg, step, n).items()}
        state, m = fn(state, rows)
        out["steps"].append({k: v.clone() for k, v in m.items()})
    return out


def forward(cfg, shd, extra) -> dict:
    from repro_torch.models.model import apply_model, whole_logits
    model = placed(cfg, shd)
    with torch.no_grad():
        out = apply_model(model, {"embeds": shd.batch_rows(
            torch.tensor(frames(cfg)))})
        return {"logits": whole_logits(model, out.logits)}


def resume(cfg, shd, extra, out_dir) -> dict:
    """Two steps whole, and one step, a save, a restore into a new model
    and one more; and from a one-card checkpoint of step 1 (the test
    writes it in ``out_dir/one_card_dir(extra)``) one step on the mesh."""
    from repro_torch.checkpoint import store
    from repro_torch.train import step as tstep
    tcfg = train_config(extra.get("quantize", False))
    fn = tstep.make_train_step(cfg, tcfg)

    def rows(step):
        return {k: shd.batch_rows(torch.tensor(x))
                for k, x in train_batch(cfg, step).items()}

    def fresh():
        return tstep.init_train_state(cfg, tcfg, placed(cfg, shd))

    state = fresh()
    for step in range(2):
        state, _ = fn(state, rows(step))
    whole = tstep.state_tree(state)
    state = fresh()
    state, _ = fn(state, rows(0))
    path = os.path.join(out_dir, f"mesh_ckpt_{one_card_dir(extra)}")
    tree = tstep.state_tree(state)
    if shd.axis("model").index == 0 and shd.axis("data").index == 0:
        store.save(path, 1, tree)
    shd.barrier()
    state = fresh()
    state = tstep.load_state_tree(state, store.restore(
        path, 1, tstep.state_like(state), device="cpu"))
    state, _ = fn(state, rows(1))
    resumed = tstep.state_tree(state)
    state = fresh()
    state = tstep.load_state_tree(state, store.restore(
        os.path.join(out_dir, one_card_dir(extra)), 1,
        tstep.state_like(state),
        device="cpu"))
    state, m = fn(state, rows(1))
    return {"whole": whole, "resumed": resumed,
            "from_one": {k: v.clone() for k, v in m.items()},
            "from_one_tree": tstep.state_tree(state)}


def collectives(shd) -> dict:
    """Each rank's ``all_gather`` over each axis of the mesh, natively and
    as the all-to-all gloo takes for CUDA tensors, along dims 0 and 1."""
    from repro_torch.models.layers import (all_gather,
                                           all_gather_by_all_to_all)
    out = {}
    t = torch.arange(12.).reshape(3, 4) + 100 * torch.distributed.get_rank()
    for a in ("data", "model"):
        ax = shd.axis(a)
        for dim in (0, 1):
            out[(a, dim)] = (all_gather(t, dim, ax),
                             all_gather_by_all_to_all(t, dim, ax))
    return out


def run(rank: int, world: int, out_dir: str) -> None:
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.models.layers import Sharder
    torch.set_num_threads(2)
    meshes = {name: DeviceMesh("cpu", torch.tensor(grid),
                               mesh_dim_names=("data", "model"))
              for name, grid in MESHES.items()}
    for case, (kind, mesh, arch, over, extra) in CASES.items():
        if not any(rank in row for row in MESHES[mesh]):
            continue
        shd = Sharder(meshes[mesh])
        if kind == "collectives":
            torch.save(collectives(shd), os.path.join(out_dir,
                                                      f"{case}.{rank}.pt"))
            continue
        cfg = config(arch, **over)
        if kind == "resume":
            got = resume(cfg, shd, extra, out_dir)
        else:
            got = {"serve": serve, "train": train,
                   "forward": forward}[kind](cfg, shd, extra)
        torch.save(got, os.path.join(out_dir, f"{case}.{rank}.pt"))
