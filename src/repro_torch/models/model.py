"""LM assembly: layer plan -> blocks -> logits, for every family.

Counterpart of ``repro/models/model.py``. The JAX package stacks each
period of the layer plan and scans over the periods; the port holds one
``Block`` per layer (``norm1``, ``mixer``, ``norm2``, ``ffn``) in
``Model.layers`` and runs them in a loop. Layer ``i`` of the port is the
JAX package's ``prefix[i]`` for ``i < n_dense_prefix`` and otherwise
``body["sub{j}"]`` at period ``r``, ``i = n_dense_prefix + r * period + j``
(``repro_torch.interop.load_params`` carries weights across that way).
``cfg.remat`` changes only what training keeps for the backward pass,
never a value. Where gradients are enabled and there are no caches,
``apply_model`` runs each period of the layer plan after the dense
prefix (the reference's scanned ``body_fn``; the prefix lies outside
it) under ``torch.utils.checkpoint`` (non-reentrant): ``"full"`` keeps
nothing inside a period and recomputes it in the backward pass
(``nothing_saveable``), ``"dots"`` keeps the outputs of ``aten.mm`` and
``aten.addmm``, the matmuls without batch dimensions, and recomputes the
rest (``checkpoint_dots_with_no_batch_dims``), ``"none"`` keeps every
activation. The recompute runs ``_FlashCore``'s forward again, so K6
launches twice a layer under ``"full"`` and ``"dots"``.

Runs the dense and token-input families (smollm-135m, chameleon-34b,
command-r-plus-104b, minitron-8b, nemotron-4-340b), the MoE family
(phi3.5-moe, deepseek-v2), the SSM family (mamba2-370m) and the hybrid
(jamba-v0.1). Where the layer plan says ``"moe"`` the block's FFN is a
``models.mlp.MoE``, routed by the auction (``router="flow"``) or top-k in
prefill and by top-k in decode, as the reference; a dense prefix
(deepseek's first layer) is a plain ``"mlp"`` in the plan. Where the plan
says ``"mamba"`` the mixer is a ``models.mamba.Mamba`` (SSD prefill,
recurrent decode, an ``SSMCache``); otherwise it is attention:
``models.attention.MLA`` where ``cfg.attn_type == "mla"`` (its cache holds
``c_kv`` and ``k_rope``), else ``GQA``, with RoPE only where
``cfg.rope_theta`` is set (jamba has none). The hybrid's plan puts
attention at every ``attn_period``-th layer and mamba elsewhere.

The encoder (hubert-xlarge: ``causal=False``, a ``frontend_dim``) runs
the same blocks with non-causal attention: ``frontend`` (a bias-free
``nn.Linear``) projects ``batch["embeds"]`` in place of the token lookup,
and where the config is neither causal nor has RoPE the sinusoidal
positions (``layers.sinusoidal_pos``) are added to it. ``embed`` stays a
parameter there, as in the JAX tree, and gets a zero gradient. With
``cfg.kv_quant`` the attention caches are ``KVCacheQ`` (int8 codes and
float32 scales, ``models.attention``).

On a mesh (``shard_model``, ``models.layers.Sharder``) each rank holds
its shard of every parameter, placed by ``param_axes`` (the reference's
logical axes, transposed where ``nn.Linear`` stores ``(out, in)``) and
``Sharder.spec``, and runs the reference's program on its rows of the
batch: each ``Block`` runs on its parameters gathered over ``data``
(FSDP, ``Sharder.param``), attention and the MLPs split their heads,
hidden units and experts over ``model`` (``models/attention.py``,
``models/mlp.py``), the embedding and the logits their vocabulary, and
the caches (``init_caches``) their rows over the batch axes and their
sequence over ``model``. ``apply_model`` then returns this rank's logits:
its block of the vocabulary where ``model`` splits it (the reference's
constraint of the logits), which ``whole_logits`` makes whole.
"""
from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (GQA, MLA, KVCache, KVCacheQ,
                                         init_gqa, init_mla)
from repro_torch.models.layers import (NO_MESH, Norm, Sharder, dense_std,
                                       linear, normal_, sinusoidal_pos)
from repro_torch.models.mamba import Mamba, SSMCache, init_mamba
from repro_torch.models.mlp import MLP, MoE, init_mlp, init_moe


# ---------------------------------------------------------------------------
# Layer plan
# ---------------------------------------------------------------------------

def layer_plan(cfg: ModelConfig) -> list[tuple[str, str | None]]:
    plan = []
    for i in range(cfg.n_layers):
        if cfg.family == "ssm":
            mixer = "mamba"
        elif cfg.family == "hybrid":
            mixer = "attn" if i % cfg.attn_period == 0 else "mamba"
        else:
            mixer = "attn"
        if (cfg.moe is not None and i >= cfg.n_dense_prefix
                and (i - cfg.n_dense_prefix) % cfg.moe.every == 0):
            ffn = "moe"
        elif cfg.d_ff:
            ffn = "mlp"
        else:
            ffn = None
        plan.append((mixer, ffn))
    return plan


def plan_period(cfg: ModelConfig) -> int:
    period = cfg.attn_period if cfg.family == "hybrid" else 1
    if cfg.moe is not None:
        period = math.lcm(period, cfg.moe.every)
    assert (cfg.n_layers - cfg.n_dense_prefix) % period == 0, cfg.name
    return period


# ---------------------------------------------------------------------------
# Modules and init
# ---------------------------------------------------------------------------

def _mixer_class(cfg: ModelConfig, mixer: str) -> type:
    if mixer == "mamba":
        return Mamba
    return MLA if cfg.attn_type == "mla" else GQA


class Block(nn.Module):
    """One layer: ``norm1`` -> ``mixer`` (``Mamba`` where the plan says
    ``"mamba"``; else ``MLA`` where ``cfg.attn_type`` is ``"mla"``, else
    ``GQA``) -> residual, then (where the plan has an FFN) ``norm2`` ->
    ``ffn`` (an ``MLP``, or a ``MoE`` where the plan says ``"moe"``) ->
    residual."""

    def __init__(self, cfg: ModelConfig, spec, device=None, dtype=None):
        super().__init__()
        mixer, ffn = spec
        self.norm1 = Norm(cfg.d_model, cfg.norm, device, dtype)
        self.mixer = _mixer_class(cfg, mixer)(cfg, device, dtype)
        if ffn:
            self.norm2 = Norm(cfg.d_model, cfg.norm, device, dtype)
            self.ffn = (MoE if ffn == "moe" else MLP)(cfg, device=device,
                                                      dtype=dtype)

    def forward(self, x, *, positions, cache, decode: bool,
                shd: Sharder = NO_MESH, gathered: bool = False):
        if shd.mesh is not None and not gathered:
            # FSDP: the block runs on its parameters gathered over data
            return gathered_call(self, shd, x, positions=positions,
                                 cache=cache, decode=decode, shd=shd,
                                 gathered=True)
        mo, new_cache = self.mixer(self.norm1(x), positions=positions,
                                   cache=cache, decode=decode, shd=shd)
        x = x + mo
        if isinstance(getattr(self, "ffn", None), MoE):
            x = x + self.ffn(self.norm2(x), decode=decode, shd=shd)
        elif hasattr(self, "ffn"):
            x = x + self.ffn(self.norm2(x), shd=shd)
        return x, new_cache


def gathered_call(module: nn.Module, sharder: Sharder, *args, **kw):
    """``module(*args, **kw)`` on its parameters as ``sharder.param``
    gives them (gathered over data); the module itself without a mesh."""
    if sharder.mesh is None:
        return module(*args, **kw)
    return torch.func.functional_call(
        module, {n: sharder.param(p) for n, p in module.named_parameters()},
        args, kw)


class Model(nn.Module):
    """The port's LM: with ``cfg.frontend_dim`` a ``frontend`` projection
    (``frontend_dim`` -> ``d_model``), ``embed`` ``(vocab, d_model)``,
    ``layers`` (one ``Block`` each), ``final_norm`` and, untied,
    ``lm_head``. Built with uninitialised weights: ``init_model`` draws
    them, ``repro_torch.interop.load_params`` copies the JAX package's."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        if cfg.frontend_dim:
            self.frontend = linear(cfg.frontend_dim, cfg.d_model, dev, dtype)
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model,
                                              device=dev, dtype=dtype))
        self.layers = nn.ModuleList(
            Block(cfg, spec, dev, dtype) for spec in layer_plan(cfg))
        self.final_norm = Norm(cfg.d_model, cfg.norm, dev, dtype)
        if not cfg.tie_embeddings:
            self.lm_head = linear(cfg.d_model, cfg.vocab, dev, dtype)
        self.shd = NO_MESH      # shard_model places it on a mesh

    def forward(self, batch, **kw) -> "ModelOutput":
        return apply_model(self, batch, **kw)


def init_model(cfg: ModelConfig, generator: torch.Generator, *, device=None,
               dtype=torch.float32) -> Model:
    """A model with random weights drawn from ``generator``: the JAX
    ``init_model``'s standard deviations (``fan_in ** -0.5``; the embedding
    ``d_model ** -0.5``; ``wo`` and ``w2`` depth-scaled; norm gains 1 and
    biases 0; the frontend ``frontend_dim ** -0.5``; MLA's, mamba's and
    the MoE's as ``init_mla``, ``init_mamba`` and ``init_moe`` say).
    Runs on ``device`` (default cuda); the generator may live on the
    CPU."""
    model = Model(cfg, device=device, dtype=dtype)
    if cfg.frontend_dim:
        normal_(model.frontend.weight, dense_std(cfg.frontend_dim),
                generator)
    # d^-0.5 embedding scale keeps tied-head logits ~N(0,1) at init
    normal_(model.embed, cfg.d_model ** -0.5, generator)
    for block in model.layers:
        init = {Mamba: init_mamba, MLA: init_mla, GQA: init_gqa}[
            type(block.mixer)]
        init(block.mixer, generator)
        if isinstance(getattr(block, "ffn", None), MoE):
            init_moe(block.ffn, generator)
        elif hasattr(block, "ffn"):
            init_mlp(block.ffn, generator)
    if not cfg.tie_embeddings:
        normal_(model.lm_head.weight, dense_std(cfg.d_model), generator)
    return model


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

# the reference's logical axes of the top-level leaves, in the port's layout
# (``frontend`` and ``lm_head`` are nn.Linear: (out, in), the JAX matrix
# transposed; ``embed`` keeps the JAX layout)
_TOP_AXES = {"embed": ("tp", "fsdp"), "frontend.weight": ("fsdp", None),
             "lm_head.weight": ("tp", "fsdp")}


def param_axes(model: Model) -> dict:
    """``{parameter name: logical axes}`` in the port's layout: each
    module's ``AXES`` (the reference's ``ParamFactory`` declarations,
    reversed for an ``nn.Linear`` weight) under its path."""
    out = {}
    for name, _ in model.named_parameters():
        if name in _TOP_AXES:
            out[name] = _TOP_AXES[name]
            continue
        owner, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(owner)
        if isinstance(mod, nn.Linear):      # weight of an nn.Linear child
            owner, lin = owner.rsplit(".", 1)
            leaf = f"{lin}.{leaf}"
            mod = model.get_submodule(owner)
        out[name] = type(mod).AXES[leaf]
    return out


def shard_model(model: Model, shd: Sharder, device=None,
                fsdp: bool = True) -> Model:
    """Place ``model`` (whole parameters, on any device, ``meta`` too) on
    ``shd``'s mesh: each parameter is replaced by this rank's block of it
    (a copy, on ``device`` if given), with its spec as ``.spec``, and the
    model runs on ``shd`` from then on. Returns ``model``.

    ``fsdp=False`` is the serving placement: the ``"fsdp"`` dims stay
    whole, so each weight is split over ``model`` only and no step
    gathers it over ``data`` (the reference's placement, the default,
    gathers each weight at every use)."""
    axes = param_axes(model)
    if not fsdp:
        axes = {n: tuple(None if a == "fsdp" else a for a in ax)
                for n, ax in axes.items()}
    specs = {n: shd.spec(p.shape, axes[n])
             for n, p in model.named_parameters()}
    for name, spec in specs.items():
        owner, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        mod = model.get_submodule(owner)
        old = getattr(mod, leaf)
        block = shd.shard(old.detach(), spec)
        block = block.to(device or block.device, copy=True).contiguous()
        new = nn.Parameter(block, requires_grad=old.requires_grad)
        new.spec = spec
        setattr(mod, leaf, new)
    model.shd = shd
    return model


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

class ModelOutput(NamedTuple):
    logits: torch.Tensor
    caches: Any


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, func, *args, **kwargs):
    """``"dots"``: keep the matmuls without batch dimensions."""
    return (CheckpointPolicy.MUST_SAVE if func in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _run_blocks(blocks, x, positions, shd=NO_MESH):
    for block in blocks:
        x, _ = block(x, positions=positions, cache=None, decode=False,
                     shd=shd)
    return x


def _remat_blocks(blocks, x, positions, remat: str, shd=NO_MESH):
    """One period of the layer plan under ``torch.utils.checkpoint``. No
    RNG state is kept: no layer draws random numbers."""
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    elif remat != "full":
        raise ValueError(f"remat {remat!r}: one of full, dots, none")
    return checkpoint(_run_blocks, blocks, x, positions, shd,
                      use_reentrant=False, preserve_rng_state=False, **kw)


def _embed(model: Model, tokens, shd: Sharder):
    """The token lookup; where ``model`` splits the vocabulary, each rank
    looks up the tokens of its block and the ranks' rows are summed."""
    E = shd.param(model.embed)
    if not shd.tp(model.cfg.vocab):
        return F.embedding(tokens.long(), E)
    Vl = E.shape[0]
    local = tokens.long() - shd.axis("model").index * Vl
    hit = (local >= 0) & (local < Vl)
    rows = F.embedding(local.clamp(0, Vl - 1), E) * hit[..., None].to(E.dtype)
    return shd.reduce(rows)


def _logits(model: Model, x, shd: Sharder):
    cfg = model.cfg
    W = shd.param(model.embed if cfg.tie_embeddings
                  else model.lm_head.weight)
    if shd.tp(cfg.vocab):       # this rank's block of the vocabulary
        x = shd.enter(x)
    return x @ W.T if cfg.tie_embeddings else F.linear(x, W)


def whole_logits(model: Model, logits):
    """``apply_model``'s logits over the whole vocabulary (gathered over
    ``model`` where it splits the vocabulary)."""
    shd = model.shd
    return shd.gather(logits, -1) if shd.tp(model.cfg.vocab) else logits


def apply_model(model: Model, batch, *, caches=None, decode: bool = False,
                pos_offset=0, logits_mode: str = "all",
                remat: str | None = None) -> ModelOutput:
    """batch: ``{"tokens": (B, S) int}``, or ``{"embeds": (B, S,
    frontend_dim)}`` where the config has a frontend. ``caches``:
    ``init_caches``'s list (one ``KVCache``, ``KVCacheQ`` or ``SSMCache``
    per layer) or None. ``pos_offset`` may be an int or a 0-d tensor on
    the model's device (the decode position). ``remat`` (default
    ``cfg.remat``) applies where gradients are enabled and ``caches`` is
    None (see the module docstring). Returns the logits ``(B, S, vocab)``
    (``logits_mode="last"``: ``(B, 1, vocab)``) and the new caches (None
    without caches). On a mesh ``batch`` and ``caches`` are this rank's
    rows, and the logits are this rank's (``whole_logits``)."""
    cfg = model.cfg
    shd = model.shd
    remat = cfg.remat if remat is None else remat
    if cfg.frontend_dim:
        x = gathered_call(model.frontend, shd, batch["embeds"].to(
            model.frontend.weight.dtype))
    else:
        x = _embed(model, batch["tokens"], shd)
    S = x.shape[1]
    positions = pos_offset + torch.arange(S, device=x.device)
    if not cfg.causal and not cfg.rope_theta:
        x = x + sinusoidal_pos(positions, cfg.d_model)[None].to(x.dtype)
    new_caches = []
    if remat != "none" and caches is None and torch.is_grad_enabled():
        layers = list(model.layers)
        x = _run_blocks(layers[:cfg.n_dense_prefix], x, positions, shd)
        period = plan_period(cfg)
        for start in range(cfg.n_dense_prefix, cfg.n_layers, period):
            x = _remat_blocks(layers[start:start + period], x, positions,
                              remat, shd)
    else:
        for i, block in enumerate(model.layers):
            x, nc = block(x, positions=positions,
                          cache=caches[i] if caches is not None else None,
                          decode=decode, shd=shd)
            new_caches.append(nc)
    x = gathered_call(model.final_norm, shd, x)
    if logits_mode == "last":
        x = x[:, -1:]
    logits = _logits(model, x, shd)
    return ModelOutput(logits, new_caches if caches is not None else None)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def cache_axes(cfg: ModelConfig, spec) -> tuple:
    """The reference's logical axes of a layer's cache leaves (the
    reference's ``_layer_cache``; the stacked period axis aside)."""
    if spec[0] == "mamba":
        return SSMCache(("batch", None, None, None), ("batch", None, "tp"),
                        ())
    if cfg.attn_type == "mla":
        return KVCache(("batch", "seq", None), ("batch", "seq", None), ())
    if cfg.kv_quant:
        return KVCacheQ(*(("batch", "seq", None, None),) * 4, ())
    return KVCache(("batch", "seq", None, None), ("batch", "seq", None, None),
                   ())


def _layer_cache(cfg, spec, B, S_max, dtype, device, shd=NO_MESH):
    """GQA: ``KVCache`` k and v ``(B, S_max, KV, dh)``, or with
    ``cfg.kv_quant`` ``KVCacheQ``: int8 codes ``(B, S_max, KV, dh)`` and
    float32 scales ``(B, S_max, KV, 1)`` whatever ``dtype``; MLA:
    ``c_kv`` ``(B, S_max, kv_lora)`` and ``k_rope`` ``(B, S_max, rope)``;
    mamba: ``SSMCache`` with ``state`` ``(B, H, P, N)`` in float32
    whatever ``dtype``, ``conv`` ``(B, d_conv - 1, di + 2 N)``. On a mesh
    each leaf is this rank's block, its spec as ``.spec``."""
    if spec[0] == "mamba":
        s = cfg.ssm
        di = s.d_inner(cfg.d_model)
        leaves = (((B, s.n_heads(cfg.d_model), s.head_dim, s.d_state),
                   torch.float32), ((B, s.d_conv - 1, di + 2 * s.d_state),
                                    dtype))
    elif cfg.attn_type == "mla":
        leaves = (((B, S_max, cfg.mla.kv_lora_rank), dtype),
                  ((B, S_max, cfg.mla.qk_rope_dim), dtype))
    elif cfg.kv_quant:
        codes = (B, S_max, cfg.n_kv_heads, cfg.dh)
        leaves = ((codes, torch.int8), (codes[:-1] + (1,), torch.float32)) * 2
    else:
        leaves = (((B, S_max, cfg.n_kv_heads, cfg.dh), dtype),) * 2
    out = []
    for (shape, dt), axes in zip(leaves, cache_axes(cfg, spec)):
        sp = shd.spec(shape, axes)
        t = torch.zeros(shd.shard(torch.empty(shape, device="meta"),
                                  sp).shape, dtype=dt, device=device)
        if shd.mesh is not None:
            t.spec = sp
        out.append(t)
    length = torch.tensor(0, dtype=torch.int32, device=device)
    return type(cache_axes(cfg, spec))(*out, length)


def init_caches(cfg: ModelConfig, B: int, S_max: int, dtype=torch.bfloat16,
                device=None, shd: Sharder = NO_MESH) -> list:
    """One empty cache per layer, ``KVCache`` (``KVCacheQ`` with
    ``cfg.kv_quant``) or ``SSMCache`` by the layer's mixer (the JAX
    package stacks the body's along a leading period axis); on ``shd``'s
    mesh this rank's blocks of the ``(B, S_max, ...)`` caches."""
    dev = resolve_device(device)
    return [_layer_cache(cfg, spec, B, S_max, dtype, dev, shd)
            for spec in layer_plan(cfg)]
