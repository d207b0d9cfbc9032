"""Per-(arch × input-shape) dry-run cell builder.

Counterpart of ``repro/launch/specs.py``. For every cell this builds the
step (train / prefill / decode) and its inputs, by default on the
``meta`` device: every tensor has its shape and dtype and no storage, so
a 340 B-parameter model is built on the CPU in under a second, and
``roofline_hlo.analyze`` counts the step without running it. With
``device="cuda"`` the same cell is built on the card with weights drawn
from a ``torch.Generator`` there, and runs for real.

The model is ``Model(cfg, device=..., dtype=param_dtype)``, never
``interop.numpy_params``, which would draw every weight on the host.

On a mesh (``shd``, a ``Sharder`` of ``launch.mesh.make_production_mesh``)
the cell is rank 0's part of the SPMD step: the model placed by
``shard_model``, the rank's rows of the batch, its blocks of the caches,
the AdamW moments placed like the parameters (the reference's
``_opt_moment_specs``). ``model_axes``, ``cache_axes_of``, ``_tree_specs``
and ``_opt_moment_specs`` are the reference's: logical axes of every
parameter, cache and moment leaf and their specs on a mesh (the
reference's ``_named`` wraps specs in ``NamedSharding``s, which the port
does not use: its placement is ``Sharder.shard``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.models.layers import NO_MESH, Sharder
from repro_torch.models.model import (Model, apply_model, cache_axes,
                                      init_caches, init_model, layer_plan,
                                      param_axes, shard_model)
from repro_torch.optim.adamw import Quantized
from repro_torch.serve.engine import (ServeState, make_prefill_step,
                                      make_serve_step)
from repro_torch.train.step import (TrainConfig, init_train_state,
                                    make_train_step)

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


class Cell(NamedTuple):
    fn: Any                  # the step
    args: tuple              # its inputs, on the cell's device: the model
    #                          (or the train state holding it) first
    donate_argnums: tuple    # inputs the step updates in place
    note: str


def cell_skip_reason(cfg: ModelConfig, shape_name: str) -> str | None:
    if cfg.family == "encoder" and SHAPES[shape_name]["kind"] == "decode":
        return "encoder-only: no decode step"
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return "full quadratic attention: 500k infeasible (DESIGN.md §6)"
    return None


def model_axes(cfg: ModelConfig) -> dict:
    """``{parameter name: logical axes}`` (the port's layout), from the
    model built on ``meta``."""
    return param_axes(Model(cfg, device="meta"))


def cache_axes_of(cfg: ModelConfig) -> list:
    """Each layer's cache leaves' logical axes."""
    return [cache_axes(cfg, spec) for spec in layer_plan(cfg)]


def _tree_specs(shd: Sharder, tree: dict, axes: dict) -> dict:
    """``{name: spec}`` of whole tensors ``tree`` on ``shd``."""
    return {n: shd.spec(t.shape, axes[n]) for n, t in tree.items()}


def _opt_moment_specs(shd: Sharder, m_tree: dict, axes: dict) -> dict:
    """Specs for Adam moments: like the params, but 8-bit-quantized leaves
    (``Quantized(q, scale)``) shard their leading dims like the param and
    replicate the trailing (block, BLOCK) payload dims."""
    def spec_of(m, a):
        if isinstance(m, Quantized):
            qa = tuple(a[:-1]) + (None, None)
            return Quantized(shd.spec(m.q.shape, qa),
                             shd.spec(m.scale.shape, qa))
        return shd.spec(m.shape, a)
    return {n: spec_of(m, axes[n]) for n, m in m_tree.items()}


def resolve_config(arch: str, router_override=None, remat_override=None,
                   kv_quant: bool = False, n_layers: int | None = None):
    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if router_override and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, router=router_override))
    if remat_override:
        cfg = dataclasses.replace(cfg, remat=remat_override)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    return cfg


SEED = 0


def _generator(device, offset: int = 0):
    """A generator on ``device`` from SEED, None on ``meta``."""
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(SEED + offset)


def build_model(cfg: ModelConfig, device, dtype,
                shd: Sharder = NO_MESH) -> Model:
    """The model on ``device``: uninitialised on ``meta``, elsewhere with
    ``init_model``'s weights drawn from a generator on that device; on
    ``shd``'s mesh this rank's blocks (``shard_model``)."""
    gen = _generator(device)
    if gen is None:
        model = Model(cfg, device=device, dtype=dtype)
    else:
        model = init_model(cfg, gen, device=device, dtype=dtype)
    return model if shd.mesh is None else shard_model(model, shd)


def _rows(B: int, shd: Sharder) -> int:
    """This rank's rows of a batch of ``B``: all of them without a mesh or
    where the data-parallel ranks do not divide them (replicated, as
    ``Sharder.batch_rows``)."""
    n = shd.data_groups if shd.mesh is not None else 1
    return B if B % n else B // n


def _ids(shape, vocab: int, device, gen) -> torch.Tensor:
    if gen is None:
        return torch.empty(shape, dtype=torch.int32, device=device)
    return torch.randint(0, vocab, shape, generator=gen, dtype=torch.int32,
                         device=device)


def _fill_caches(caches, length: int, gen) -> list:
    """Caches that hold ``length`` tokens: on a real device their floating
    leaves (and an int8 cache's codes) drawn from ``gen``."""
    out = []
    for c in caches:
        if gen is not None:
            with torch.no_grad():
                for t in c[:-1]:
                    if t.dtype == torch.int8:
                        t.copy_(torch.randint(-127, 128, t.shape,
                                              generator=gen, device=t.device))
                    else:
                        t.normal_(generator=gen)
        n = torch.tensor(length, dtype=torch.int32, device=c.length.device)
        out.append(c._replace(length=n))
    return out


def train_cell(cfg: ModelConfig, B: int, S: int, *, device="meta",
               param_dtype=torch.bfloat16, tcfg: TrainConfig | None = None,
               note: str = "train_step", shd: Sharder = NO_MESH) -> Cell:
    """``make_train_step(cfg, tcfg)`` on a ``TrainState`` of a model built
    by ``build_model``, and a batch of ``B`` rows of ``S`` tokens (an
    encoder's: float32 frames of ``frontend_dim``) and their labels (on a
    mesh this rank's rows, and moments placed like the parameters)."""
    tcfg = tcfg or TrainConfig()
    gen = _generator(device, 1)
    model = build_model(cfg, device, param_dtype, shd)
    state = init_train_state(cfg, tcfg, model, replicate_moments=False)
    B = _rows(B, shd)
    if cfg.frontend_dim:
        embeds = torch.empty((B, S, cfg.frontend_dim), dtype=torch.float32,
                             device=device)
        if gen is not None:
            embeds.normal_(generator=gen)
        batch = {"embeds": embeds}
    else:
        batch = {"tokens": _ids((B, S), cfg.vocab, device, gen)}
    batch["labels"] = _ids((B, S), cfg.vocab, device, gen)
    return Cell(make_train_step(cfg, tcfg), (state, batch), (0,), note)


def build_cell(arch: str, shape_name: str, *, device="meta",
               param_dtype=torch.bfloat16,
               router_override: str | None = None,
               remat_override: str | None = None, kv_quant: bool = False,
               tcfg: TrainConfig | None = None,
               batch: int | None = None, n_layers: int | None = None,
               shd: Sharder = NO_MESH) -> Cell:
    """The cell's step and inputs on ``device``: ``batch`` (default the
    shape's global batch) rows of the shape's length, ``n_layers`` (default
    the config's) layers. Train: ``make_train_step`` on a ``TrainState``;
    prefill: ``make_prefill_step`` over empty caches of the prompt's length
    (an encoder: its forward's logits); decode: ``make_serve_step`` on a
    ``ServeState`` whose caches hold ``seq_len - 1`` tokens. On ``shd``'s
    mesh: this rank's part of it (see the module note)."""
    cfg = resolve_config(arch, router_override, remat_override, kv_quant,
                         n_layers)
    info = SHAPES[shape_name]
    S = info["seq_len"]
    B = info["global_batch"] if batch is None else batch
    tag = f"{arch}/{shape_name}"
    if info["kind"] == "train":
        return train_cell(cfg, B, S, device=device, param_dtype=param_dtype,
                          tcfg=tcfg, note=f"{tag}: train_step", shd=shd)
    gen = _generator(device, 1)
    model = build_model(cfg, device, param_dtype, shd)
    B_all, B = B, _rows(B, shd)

    if info["kind"] == "prefill":
        if cfg.frontend_dim:
            # encoder "prefill" = full forward classification at length S
            @torch.inference_mode()
            def forward(model, embeds):
                return apply_model(model, {"embeds": embeds}).logits
            embeds = torch.empty((B, S, cfg.frontend_dim),
                                 dtype=torch.float32, device=device)
            if gen is not None:
                embeds.normal_(generator=gen)
            return Cell(forward, (model, embeds), (),
                        f"{tag}: encoder forward")
        caches = init_caches(cfg, B_all, S, dtype=torch.bfloat16,
                             device=device, shd=shd)
        prefill = make_prefill_step(model)

        def prefill_step(model, tokens, caches):
            return prefill(tokens, caches)
        return Cell(prefill_step,
                    (model, _ids((B, S), cfg.vocab, device, gen), caches),
                    (2,), f"{tag}: prefill")

    # decode: cache holds seq_len-1 tokens, serve_step appends one
    caches = _fill_caches(init_caches(cfg, B_all, S, dtype=torch.bfloat16,
                                      device=device, shd=shd), S - 1, gen)
    state = ServeState(
        caches=caches, last_tokens=_ids((B,), cfg.vocab, device, gen),
        lengths=torch.full((B,), S - 1, dtype=torch.int32, device=device))
    serve = make_serve_step(model)

    def serve_step(model, state):
        return serve(state)
    return Cell(serve_step, (model, state), (1,),
                f"{tag}: serve_step (decode)")
