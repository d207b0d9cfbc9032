"""MLPs: dense (SwiGLU / squared-ReLU / GELU).

Counterpart of ``repro/models/mlp.py``, its dense half. The MoE layer
(``init_moe``, ``moe_apply``) and the routers of ``core/routing.py`` it
needs wait for ROADMAP M9 and raise.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import (ACTIVATIONS, dense_std,
                                       depth_scaled_std, linear, normal_)

NOT_PORTED = "not ported yet (ROADMAP M9: MoE with core/routing.py)"


class MLP(nn.Module):
    """``w1``, ``w2`` and, gated, ``w3`` (bias-free ``nn.Linear``)."""

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        D, F = cfg.d_model, cfg.d_ff
        self.cfg = cfg
        self.w1 = linear(D, F, device, dtype)
        self.w2 = linear(F, D, device, dtype)
        if cfg.gated_mlp:
            self.w3 = linear(D, F, device, dtype)

    def forward(self, x):
        return mlp_apply(self, x, self.cfg)


def init_mlp(p: MLP, generator: torch.Generator) -> MLP:
    """Draw ``p``'s weights from ``generator`` with the JAX ``init_mlp``'s
    stds: ``fan_in ** -0.5``, ``w2`` depth-scaled."""
    D, F = p.w1.in_features, p.w1.out_features
    normal_(p.w1.weight, dense_std(D), generator)
    normal_(p.w2.weight, depth_scaled_std(F, p.cfg.n_layers), generator)
    if p.cfg.gated_mlp:
        normal_(p.w3.weight, dense_std(D), generator)
    return p


def mlp_apply(p: MLP, x, cfg):
    h = ACTIVATIONS[cfg.mlp_act](p.w1(x))
    if cfg.gated_mlp:
        h = h * p.w3(x)
    return p.w2(h)


def init_moe(*args, **kwargs):
    raise NotImplementedError(NOT_PORTED)


def moe_apply(*args, **kwargs):
    raise NotImplementedError(NOT_PORTED)
