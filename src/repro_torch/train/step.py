"""Training step builder: loss, grads, microbatching, optimizer update.

Counterpart of ``repro/train/step.py``. The JAX package's ``TrainState``
holds a params tree and the step returns a new one; the port's holds the
``Model`` itself, whose parameters ``apply_updates`` changes in place, and
its ``OptState`` (moments keyed by parameter name). Gradients come from
``torch.autograd`` (through ``models.attention._FlashCore`` in the
attention, K6 forward on the card and the plain backward).

On a mesh (a model placed by ``models.model.shard_model``) the step runs
on this rank's rows of the batch (``Sharder.batch_rows``): the loss is
this rank's sum over the whole batch's token count (the ranks' losses
sum to the reference's mean), the cross entropy runs on the rank's block
of the vocabulary, and each parameter's gradient comes out of the
backward summed over the data-parallel ranks and placed like the
parameter (``Sharder.param``). The AdamW moments are whole on every rank
(the reference's launcher places them ``P()``) unless
``init_train_state(replicate_moments=False)`` places them like the
parameters (the reference's dry run); ``TrainState.whole_moments`` keeps
that choice, and ``optim.adamw.moment_spec`` turns it into each moment's
placement. ``state_tree`` makes the state whole (a collective),
``load_state_tree`` takes this rank's blocks of a whole one: a
checkpoint of one mesh resumes on another.

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
from repro_torch.optim.adamw import (AdamWConfig, OptState, Quantized,
                                     apply_updates, init_opt_state,
                                     moment_spec, on_moment)

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
    whole_moments: bool = True      # on a mesh: the moments' placement


def params_of(model: Model) -> dict:
    """``{name: parameter}`` in the model's order: the keys of the
    gradients and of the optimizer's moments."""
    return dict(model.named_parameters())


def loss_fn(model: Model, batch, z_loss: float = 1e-4,
            remat: str | None = None):
    """Mean token cross entropy (+ z-loss) over ``batch["labels"]``,
    weighted by ``batch["mask"]`` where given, the model run with
    ``remat`` (default its ``cfg.remat``). Returns ``(loss, {"loss",
    "tokens"})``. On a mesh ``batch`` is this rank's rows: ``loss`` is
    their part of the whole batch's mean (what this rank differentiates),
    the metrics are the whole batch's."""
    out = apply_model(model, batch, remat=remat)
    labels = batch["labels"]
    shd = model.shd
    vocab0 = None
    if shd.tp(model.cfg.vocab):
        vocab0 = shd.axis("model").index * out.logits.shape[-1]
    per_tok = softmax_cross_entropy(out.logits, labels, z_loss=z_loss,
                                    shd=shd, vocab0=vocab0)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    tokens = shd.reduce_batch(torch.sum(mask))
    loss = torch.sum(per_tok * mask) / torch.clamp_min(tokens, 1.0)
    # a replicated batch (``Sharder.batch_rows``) is counted once per data
    # rank: the ranks' losses still sum to its mean, and their gradients
    # (summed over the data ranks) to its gradient
    return loss, {"loss": shd.reduce_batch(loss),
                  "tokens": tokens / shd.row_replicas(labels)}


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
        return aux["loss"].detach(), {k: x.detach() for k, x in aux.items()}, g

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
        _, new_opt, om = apply_updates(tcfg.optimizer, params, g, state.opt,
                                       shd=state.model.shd,
                                       whole=state.whole_moments)
        return state._replace(opt=new_opt), {**aux, **om}

    return train_step


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, model: Model,
                     replicate_moments: bool = True) -> TrainState:
    """Zero moments for ``model``'s parameters: on a mesh whole on every
    rank (``replicate_moments``) or this rank's blocks, placed like the
    parameters (``optim.adamw.moment_spec``)."""
    return TrainState(model=model,
                      opt=init_opt_state(tcfg.optimizer, params_of(model),
                                         model.shd, whole=replicate_moments),
                      whole_moments=replicate_moments)


def _moment_specs(state: TrainState) -> dict:
    """``{name: moment_spec}`` of the state's moments on its mesh."""
    return {n: moment_spec(p.spec, isinstance(state.opt.m[n], Quantized),
                           state.whole_moments)
            for n, p in params_of(state.model).items()}


def _moments(opt: OptState, fn) -> OptState:
    """``opt`` with ``fn(name, moment)`` in place of each of m and v."""
    return opt._replace(**{k: {n: fn(n, m) for n, m in getattr(opt, k)
                               .items()} for k in ("m", "v")})


def state_tree(state: TrainState) -> dict:
    """The train state as a tree of tensors for ``checkpoint.store``:
    ``{"opt": OptState, "params": {name: tensor}}``. On a mesh every leaf
    is whole (gathered: every rank takes part), so the tree is the one
    card's."""
    shd = state.model.shd
    live = params_of(state.model)
    params = {n: p.detach() for n, p in live.items()}
    opt = state.opt
    if shd.mesh is not None:
        ms = _moment_specs(state)
        params = {n: shd.unshard(params[n], p.spec) for n, p in live.items()}
        opt = _moments(opt, lambda n, m: on_moment(shd.unshard, m, ms[n]))
    return {"opt": opt, "params": params}


def load_state_tree(state: TrainState, tree: dict) -> TrainState:
    """``state`` with its model's parameters copied in place from a
    ``state_tree`` (say, ``store.restore``'s) and that tree's
    ``OptState``, its step counter back on the host. On a mesh ``tree``
    is whole (any mesh's, or one card's) and each rank takes its blocks."""
    params = params_of(state.model)
    shd = state.model.shd
    if tree["params"].keys() != params.keys():
        raise ValueError("the tree's parameters are not the model's")
    opt = tree["opt"]
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(shd.shard(tree["params"][n], p.spec)
                    if shd.mesh is not None else tree["params"][n])
    if shd.mesh is not None:
        ms = _moment_specs(state)
        opt = _moments(opt, lambda n, m: on_moment(
            lambda t, s: shd.shard(t, s).contiguous(), m, ms[n]))
    return state._replace(opt=opt._replace(step=opt.step.cpu()))


def state_like(state: TrainState) -> dict:
    """A ``state_tree`` of ``meta`` tensors of the whole shapes (no
    collective, nothing allocated): the ``like_tree`` of a restore."""
    shd = state.model.shd
    tree = {"opt": state.opt, "params": dict(params_of(state.model))}
    if shd.mesh is None:
        return tree

    def meta(t, spec):
        return torch.empty(shd.full_shape(t.shape, spec), dtype=t.dtype,
                           device="meta")
    ms = _moment_specs(state)
    return {"opt": _moments(state.opt, lambda n, m: on_moment(meta, m,
                                                              ms[n])),
            "params": {n: meta(p, p.spec)
                       for n, p in tree["params"].items()}}
