"""AdamW with optional 8-bit moment quantization, on named parameters.

Counterpart of ``repro/optim/adamw.py``. The moments live beside the
parameters on the same device. On a mesh (parameters placed by
``models.model.shard_model``, gradients placed like them) the caller
says where the moments are, and ``moment_spec`` places each one: whole
on every rank (``whole=True``, the reference's launcher's ``P()``), or
like its parameter (the reference's dry run, ``_opt_moment_specs``),
where a ``Quantized`` moment keeps its last dim whole, since its blocks
of ``BLOCK`` run along it. The gradient is gathered over the dims its
moment holds whole, the update computed there and the rank's block of
it applied, so each rank's parameters change exactly as the one card's
would for the same gradients. The gradient norm is summed over the
ranks' blocks, each block once. The JAX package maps over a params tree
and returns new arrays; the port keys parameters, gradients and moments
by parameter name (the names of ``Model.named_parameters()``) and
updates the parameters in place under ``torch.no_grad()``. The arithmetic is the reference's, in
its operation order and in float32.

``quantize_moments=True`` stores m and v as int8 with one float32 scale
per block of ``BLOCK`` values along the last axis, v as ``sqrt(v)``
(``Quantized``). The blocks run along each tensor's own last axis: the
port's ``nn.Linear`` weights are the JAX matrices transposed and one
tensor per layer where the JAX package stacks a layer axis, so a model's
quantized moments are blocked differently from the JAX package's; the
tests hold ``apply_updates`` to JAX's on the same tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

BLOCK = 256


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_moments: bool = False


class Quantized(NamedTuple):
    q: torch.Tensor         # int8 payload (..., blocks, BLOCK)
    scale: torch.Tensor     # float32 per-block scales (..., blocks, 1)


def _quantize(x: torch.Tensor) -> Quantized:
    """Blocks of ``BLOCK`` along the last axis (zero-padded), each scaled
    by its largest |value| / 127 and rounded half to even, as
    ``jnp.round``."""
    blocks = torch.nn.functional.pad(x, (0, -x.shape[-1] % BLOCK))
    blocks = blocks.reshape(*x.shape[:-1], -1, BLOCK)
    scale = blocks.abs().amax(-1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp_min(scale, 1e-12)).to(torch.int8)
    return Quantized(q, scale.float())


def _dequantize(qv: Quantized, shape) -> torch.Tensor:
    x = (qv.q.float() * qv.scale).reshape(*qv.q.shape[:-2], -1)
    return x[..., :shape[-1]].reshape(shape)


class OptState(NamedTuple):
    step: torch.Tensor      # 0-d int32, on the host
    m: Any                  # {name: float32 tensor or Quantized}
    v: Any                  # {name: float32 tensor or Quantized (sqrt v)}


def lr_schedule(cfg: AdamWConfig, step):
    """Linear warm-up to ``lr_peak``, then a cosine down to ``lr_min`` at
    ``decay_steps``; float32 of ``step`` (a 0-d int tensor or an int)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    s = step.float()
    peak, pi = (torch.tensor(x, device=step.device)     # float32, as JAX's
                for x in (cfg.lr_peak, math.pi))
    warm = peak * (s + 1) / cfg.warmup_steps
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * \
        (1 + torch.cos(pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def quantizes(cfg: AdamWConfig, shape) -> bool:
    """Whether the moments of a parameter of (whole) ``shape`` are
    ``Quantized``: with ``cfg.quantize_moments``, where it has an axis and
    at least ``BLOCK`` values."""
    return cfg.quantize_moments and len(shape) >= 1 \
        and math.prod(shape) >= BLOCK


def moment_spec(spec, quantized: bool, whole: bool) -> tuple:
    """The placement of a moment over its parameter's dims, for a
    parameter placed by ``spec``: nothing split where the moments are
    ``whole``, else the parameter's, but a ``Quantized`` moment keeps its
    last dim whole (the reference's ``_opt_moment_specs``)."""
    if whole:
        return (None,) * len(spec)
    return tuple(spec[:-1]) + (None,) if quantized else tuple(spec)


def on_moment(fn, m, ms):
    """``fn(tensor, spec)`` on a moment placed by ``ms``; on a
    ``Quantized`` one its payload and scales, whose leading dims are
    placed by ``ms`` and whose (blocks, BLOCK) dims are whole."""
    if isinstance(m, Quantized):
        qs = tuple(ms[:-1]) + (None, None)
        return Quantized(fn(m.q, qs), fn(m.scale, qs))
    return fn(m, ms)


def init_opt_state(cfg: AdamWConfig, params: dict, shd=None,
                   whole: bool = True) -> OptState:
    """Zero moments (float32) per named parameter on its device,
    ``Quantized`` where ``quantizes``; step 0. On ``shd``'s mesh each
    parameter's moments are of its whole shape placed by ``moment_spec``
    (``whole``: whole on every rank). The step counter stays on the
    host: the schedule and the bias corrections are computed there, in the
    reference's float32 operations (the card's division of a tensor by a
    scalar multiplies by its reciprocal, one ulp off), and no step waits
    for the device to read it."""
    mesh = shd is not None and shd.mesh is not None

    def zero_like(p):
        shape = shd.full_shape(p.shape, p.spec) if mesh else p.shape
        quantized = quantizes(cfg, shape)
        if mesh:
            ms = moment_spec(p.spec, quantized, whole)
            shape = shd.shard(torch.empty(shape, device="meta"), ms).shape
        z = torch.zeros(shape, dtype=torch.float32, device=p.device)
        return _quantize(z) if quantized else z
    return OptState(step=torch.zeros((), dtype=torch.int32),
                    m={n: zero_like(p) for n, p in params.items()},
                    v={n: zero_like(p) for n, p in params.items()})


# v (second moment) is quantized in sqrt-space: its dynamic range spans many
# decades and symmetric int8 floors small entries to zero, which explodes
# the update denominator. sqrt compresses the range so 127 levels give <1%
# error on the denominator.


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


def _mesh_norm(shd, params: dict, grads: dict) -> torch.Tensor:
    """``global_norm`` of gradients placed like their parameters: each
    block's squares over the ranks that hold it, summed over the mesh."""
    sq = sum(torch.sum(torch.square(grads[n].float()))
             / shd.replicas(p.spec) for n, p in params.items())
    return torch.sqrt(shd.reduce_all(sq))


def apply_updates(cfg: AdamWConfig, params: dict, grads: dict,
                  state: OptState, shd=None, whole: bool = True):
    """One AdamW step with global-norm clipping: every ``params[name]`` is
    updated in place from ``grads[name]``. Returns ``(params, new_state,
    {"lr", "grad_norm"})``; the state's moments are new tensors. ``lr``
    and the new step are on the host, with the state's step. ``shd``: the
    parameters' ``Sharder``; ``whole``: the moments' placement on its
    mesh, as ``init_opt_state`` made them (see the module note)."""
    mesh = shd is not None and shd.mesh is not None
    step = state.step + 1
    lr = lr_schedule(cfg, state.step)
    gnorm = _mesh_norm(shd, params, grads) if mesh else \
        global_norm(grads[n] for n in params)
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                           1.0)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()
    new_m, new_v = {}, {}
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name].float() * clip
            m, v = state.m[name], state.v[name]
            quantized = isinstance(m, Quantized)
            if mesh:        # the gradient over the dims its moment holds
                ms = moment_spec(p.spec, quantized, whole)
                gs = tuple(e if w is None else None
                           for e, w in zip(p.spec, ms))
                g = shd.unshard(g, gs)
            shape = g.shape
            if quantized:
                m = _dequantize(m, shape)
                v = _dequantize(v, shape) ** 2        # stored as sqrt(v)
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * g * g
            u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if mesh:
                u = shd.shard(u, gs)
            p32 = p.float()
            p.copy_((p32 - lr * (u + cfg.weight_decay * p32)).to(p.dtype))
            if quantized:
                m, v = _quantize(m), _quantize(torch.sqrt(v))
            new_m[name], new_v[name] = m, v
    return params, OptState(step, new_m, new_v), \
        {"lr": lr, "grad_norm": gnorm}
