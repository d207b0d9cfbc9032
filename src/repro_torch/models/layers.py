"""Shared model building blocks: parameter init, norms, activations, RoPE,
the encoder's sinusoidal positions, the token cross entropy.

Counterpart of ``repro/models/layers.py``. One card has no mesh, so there
is no ``Sharder``: the JAX package's sharding constraints are no-ops
without a mesh, and the port leaves them out. Parameter init takes an
explicit ``torch.Generator`` and uses the standard deviations of
``ParamFactory.dense``; the numbers differ from ``jax.random``'s, so the
parity tests carry weights across (``repro_torch.interop``) instead.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn


def normal_(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fill ``p`` in place with N(0, std^2) draws from ``generator``.

    Draws on the generator's device and copies, so a CPU generator can
    initialise a model on the card."""
    with torch.no_grad():
        w = torch.randn(p.shape, generator=generator, dtype=p.dtype,
                        device=generator.device)
        p.copy_(w.mul_(std))


def dense_std(fan_in: int) -> float:
    """``ParamFactory.dense``'s default standard deviation."""
    return fan_in ** -0.5


def depth_scaled_std(fan_in: int, n_layers: int) -> float:
    """The std of the residual output projections (``wo``, ``w2``)."""
    return fan_in ** -0.5 / (2 * n_layers) ** 0.5


def linear(d_in: int, d_out: int, device, dtype) -> nn.Linear:
    """A bias-free ``nn.Linear``; its ``weight`` is the JAX ``(d_in,
    d_out)`` matrix transposed."""
    return nn.Linear(d_in, d_out, bias=False, device=device, dtype=dtype)


def rmsnorm(x, g, eps=1e-6):
    x32 = x.float()
    scale = torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * g


def layernorm(x, g, b, eps=1e-5):
    x32 = x.float()
    mu = torch.mean(x32, -1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, -1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * g + b


class Norm(nn.Module):
    """RMSNorm (``g``) or LayerNorm (``g``, ``b``), by ``cfg.norm``."""

    def __init__(self, d: int, kind: str, device=None, dtype=None):
        super().__init__()
        self.kind = kind
        self.g = nn.Parameter(torch.ones(d, device=device, dtype=dtype))
        if kind == "layernorm":
            self.b = nn.Parameter(torch.zeros(d, device=device, dtype=dtype))

    def forward(self, x):
        if self.kind == "layernorm":
            return layernorm(x, self.g, self.b)
        return rmsnorm(x, self.g)


def relu2(x):
    r = F.relu(x)
    return r * r


def gelu_tanh(x):
    """``jax.nn.gelu``, whose default is the tanh approximation."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS: dict[str, Callable] = {
    "relu2": relu2,          # nemotron/minitron squared-ReLU
    "gelu": gelu_tanh,
    "silu": F.silu,
}


def apply_rope(x, positions, theta: float = 10_000.0):
    """Table-free RoPE (rotate half). x: (B, S, H, D); positions: (S,) int.

    Frequencies are float32 and come from ``positions`` directly, as in
    the JAX package: no (max_seq, D/2) table.
    """
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    f = positions.to(torch.float32)[:, None] * inv[None, :]    # (S, D/2)
    c = torch.cos(f)[None, :, None, :]
    s = torch.sin(f)[None, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


def sinusoidal_pos(positions, d_model: int):
    """The encoder's positional embedding ``(S, d_model)`` float32, on
    ``positions``' device: ``[sin(f), cos(f)]`` with ``f = positions *
    inv`` and ``inv = 1 / 10000 ** (arange(half) / half)``, as the JAX
    package's (a stub for HuBERT's convolutional positions)."""
    half = d_model // 2
    inv = 1.0 / (10_000.0 ** (torch.arange(half, dtype=torch.float32,
                                           device=positions.device) / half))
    f = positions.to(torch.float32)[:, None] * inv[None, :]
    return torch.cat([torch.sin(f), torch.cos(f)], dim=-1)


def softmax_cross_entropy(logits, labels, z_loss: float = 0.0):
    """Token cross entropy with an optional z-loss, reduced in float32:
    ``lse - label_logit`` (+ ``z_loss * lse ** 2``), shape of ``labels``.

    The reference takes the label logit with a masked sum (a vocab-sharded
    gather would all-gather the logits on its mesh); that sum adds only
    zeros besides the label's logit, so the ``gather`` here gives the same
    value.
    """
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse ** 2
    return loss
