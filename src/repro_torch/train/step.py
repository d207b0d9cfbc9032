"""Training step builder: loss, grads, microbatching, optimizer update.

Counterpart of ``repro/train/step.py``. The JAX package's ``TrainState``
holds a params tree and the step returns a new one; the port's holds the
``Model`` itself, whose parameters ``apply_updates`` changes in place, and
its ``OptState`` (moments keyed by parameter name). There is no mesh, so
no ``axes`` and no ``Sharder``; gradients come from ``torch.autograd``
(through ``models.attention._FlashCore`` in the attention, K6 forward on
the card and the plain backward).

The step follows ``cfg.remat`` of the config it is made for, as the
reference's ``jax.checkpoint`` of the scanned body: ``"full"`` (every
config's default) recomputes each period of the layer plan in the
backward pass, ``"dots"`` keeps its matmuls without batch dimensions,
``"none"`` keeps every activation (``models/model.py``). It changes what
the backward pass keeps and how much it recomputes, never a value.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import softmax_cross_entropy
from repro_torch.models.model import Model, apply_model
from repro_torch.optim.adamw import (AdamWConfig, OptState, apply_updates,
                                     init_opt_state)

GRAD_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    num_microbatches: int = 1
    grad_dtype: str = "f32"          # "bf16": gradients summed in bfloat16
    z_loss: float = 1e-4


class TrainState(NamedTuple):
    model: Model
    opt: OptState


def params_of(model: Model) -> dict:
    """``{name: parameter}`` in the model's order: the keys of the
    gradients and of the optimizer's moments."""
    return dict(model.named_parameters())


def loss_fn(model: Model, batch, z_loss: float = 1e-4,
            remat: str | None = None):
    """Mean token cross entropy (+ z-loss) over ``batch["labels"]``,
    weighted by ``batch["mask"]`` where given, the model run with
    ``remat`` (default its ``cfg.remat``). Returns ``(loss, {"loss",
    "tokens"})``."""
    out = apply_model(model, batch, remat=remat)
    labels = batch["labels"]
    per_tok = softmax_cross_entropy(out.logits, labels, z_loss=z_loss)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    loss = torch.sum(per_tok * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return loss, {"loss": loss, "tokens": torch.sum(mask)}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the
    gradients of ``loss_fn`` (with ``num_microbatches > 1`` summed over
    equal row slices of the batch in ``grad_dtype``, then divided), cast
    to ``grad_dtype``, and one ``apply_updates``. Metrics: ``loss``,
    ``tokens`` (0 with microbatches, as the reference), ``lr``,
    ``grad_norm``, as tensors. A parameter the loss does not reach (an
    encoder's ``embed``) gets a zero gradient, as ``jax.grad`` gives. The
    model runs with ``cfg.remat``."""
    gdt = GRAD_DTYPES[tcfg.grad_dtype]

    def grads_of(params: dict, model: Model, batch):
        loss, aux = loss_fn(model, batch, z_loss=tcfg.z_loss,
                            remat=cfg.remat)
        g = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
        g = {n: torch.zeros_like(p) if x is None else x
             for (n, p), x in zip(params.items(), g)}
        return loss.detach(), {k: x.detach() for k, x in aux.items()}, g

    def train_step(state: TrainState, batch):
        params = params_of(state.model)
        if tcfg.num_microbatches > 1:
            mb = tcfg.num_microbatches
            n = next(iter(batch.values())).shape[0]
            if n % mb:
                raise ValueError(f"a batch of {n} rows does not split into "
                                 f"{mb} microbatches")
            rows = n // mb
            g = {n: torch.zeros(p.shape, dtype=gdt, device=p.device)
                 for n, p in params.items()}
            loss = 0.0
            for i in range(mb):
                part = {k: x[i * rows:(i + 1) * rows]
                        for k, x in batch.items()}
                loss_i, _, g_i = grads_of(params, state.model, part)
                g = {n: g[n] + g_i[n].to(gdt) for n in g}
                loss = loss + loss_i
            g = {n: x / mb for n, x in g.items()}
            loss = loss / mb
            aux = {"loss": loss, "tokens": torch.zeros((), device=loss.device)}
        else:
            loss, aux, g = grads_of(params, state.model, batch)
            g = {n: x.to(gdt) for n, x in g.items()}
        _, new_opt, om = apply_updates(tcfg.optimizer, params, g, state.opt)
        return TrainState(state.model, new_opt), {**aux, **om}

    return train_step


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                     model: Model) -> TrainState:
    return TrainState(model=model,
                      opt=init_opt_state(tcfg.optimizer, params_of(model)))


def state_tree(state: TrainState) -> dict:
    """The train state as a tree of tensors for ``checkpoint.store``:
    ``{"opt": OptState, "params": {name: tensor}}``."""
    return {"opt": state.opt,
            "params": {n: p.detach() for n, p in params_of(state.model)
                       .items()}}


def load_state_tree(state: TrainState, tree: dict) -> TrainState:
    """``state`` with its model's parameters copied in place from a
    ``state_tree`` (say, ``store.restore``'s) and that tree's
    ``OptState``, its step counter back on the host."""
    params = params_of(state.model)
    if tree["params"].keys() != params.keys():
        raise ValueError("the tree's parameters are not the model's")
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(tree["params"][n])
    opt = tree["opt"]
    return TrainState(state.model, opt._replace(step=opt.step.cpu()))
