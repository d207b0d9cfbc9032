"""MLPs: dense (SwiGLU / squared-ReLU / GELU) and MoE with flow routing.

Counterpart of ``repro/models/mlp.py``. The MoE layer is where the
paper's technique is a first-class feature: ``cfg.moe.router == "flow"``
routes tokens with the capacity-constrained eps-auction of
``repro_torch.core.routing`` (the assignment problem of section 5 solved
inside every MoE layer), ``"topk"`` is the standard baseline.

Dispatch is sort-based (a stable sort by expert id, then capacity slots),
as in the reference. The tokens route in ``G = gcd(data_groups, T)``
groups, each with its own capacity and routing problem, as the
reference's ``moe_apply``: one group on one card (``Sharder()``; a
subclass whose ``data_groups`` is n routes one card's batch as n data
ranks would), one a data-parallel rank on a mesh (each rank's rows of
the batch are its group). The expert products are batched matrix products (``torch.bmm``),
as the reference's ``einsum``s are plain XLA ops and no Pallas kernel.

On a model axis the MLP splits its hidden units (``w1`` / ``w3``
columns, ``w2`` rows; the partial outputs summed), and the MoE its
experts where the axis divides them: the ranks of ``model`` hold the same
tokens and route them alike, each runs the experts it holds on the
tokens dispatched to them, and the ranks' partial combines are summed
(one all-reduce where the reference's partitioner places an all-to-all).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core.routing import auction_route, topk_route
from repro_torch.models.layers import (ACTIVATIONS, NO_MESH, Sharder,
                                       dense_std, depth_scaled_std, linear,
                                       normal_)


class MLP(nn.Module):
    """``w1``, ``w2`` and, gated, ``w3`` (bias-free ``nn.Linear``); hidden
    width ``d_ff`` (default ``cfg.d_ff``)."""
    # the reference's logical axes, transposed into nn.Linear's (out, in)
    AXES = {"w1.weight": ("tp", "fsdp"), "w3.weight": ("tp", "fsdp"),
            "w2.weight": ("fsdp", "tp")}

    def __init__(self, cfg, device=None, dtype=None, d_ff: int | None = None):
        super().__init__()
        D, F = cfg.d_model, d_ff or cfg.d_ff
        self.cfg = cfg
        self.d_ff = F
        self.w1 = linear(D, F, device, dtype)
        self.w2 = linear(F, D, device, dtype)
        if cfg.gated_mlp:
            self.w3 = linear(D, F, device, dtype)

    def forward(self, x, shd: Sharder = NO_MESH):
        return mlp_apply(self, x, self.cfg, shd)


def init_mlp(p: MLP, generator: torch.Generator) -> MLP:
    """Draw ``p``'s weights from ``generator`` with the JAX ``init_mlp``'s
    stds: ``fan_in ** -0.5``, ``w2`` depth-scaled."""
    D, F = p.w1.in_features, p.w1.out_features
    normal_(p.w1.weight, dense_std(D), generator)
    normal_(p.w2.weight, depth_scaled_std(F, p.cfg.n_layers), generator)
    if p.cfg.gated_mlp:
        normal_(p.w3.weight, dense_std(D), generator)
    return p


def mlp_apply(p: MLP, x, cfg, shd: Sharder = NO_MESH):
    split = shd.tp(p.d_ff)          # this rank's block of the hidden units
    if split:
        x = shd.enter(x)
    h = ACTIVATIONS[cfg.mlp_act](p.w1(x))
    if cfg.gated_mlp:
        h = h * p.w3(x)
    return shd.reduce(p.w2(h)) if split else p.w2(h)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

class MoE(nn.Module):
    """The MoE layer's parameters: ``gate`` (bias-free ``nn.Linear(D, E)``),
    the expert tensors ``w1``, ``w3`` ``(E, D, F)`` and ``w2`` ``(E, F, D)``
    in the JAX layout, and, with ``n_shared``, the ``shared`` MLP of width
    ``F * n_shared``."""
    AXES = {"gate.weight": (None, "fsdp"), "w1": ("tp", "fsdp", None),
            "w3": ("tp", "fsdp", None), "w2": ("tp", None, "fsdp")}

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        e, D = cfg.moe, cfg.d_model
        E, F = e.n_experts, e.d_ff_expert
        self.cfg = cfg
        self.gate = linear(D, E, device, dtype)

        def experts(*shape):
            return nn.Parameter(torch.empty(shape, device=device,
                                            dtype=dtype))
        self.w1 = experts(E, D, F)
        self.w2 = experts(E, F, D)
        if cfg.gated_mlp:
            self.w3 = experts(E, D, F)
        if e.n_shared:
            self.shared = MLP(cfg, device, dtype, d_ff=F * e.n_shared)

    def forward(self, x, decode: bool = False, shd: Sharder = NO_MESH):
        return moe_apply(self, x, self.cfg, decode=decode, shd=shd)


def init_moe(p: MoE, generator: torch.Generator) -> MoE:
    """Draw ``p``'s weights with the JAX ``init_moe``'s stds: ``gate``
    ``d_model ** -0.5``; ``w1`` and ``w3`` ``n_experts ** -0.5``, since
    the reference's ``ParamFactory.dense`` takes ``fan_in = shape[0]``,
    the expert axis; ``w2`` ``d_ff_expert ** -0.5`` depth-scaled."""
    e, cfg = p.cfg.moe, p.cfg
    normal_(p.gate.weight, dense_std(cfg.d_model), generator)
    normal_(p.w1, dense_std(e.n_experts), generator)
    normal_(p.w2, depth_scaled_std(e.d_ff_expert, cfg.n_layers), generator)
    if cfg.gated_mlp:
        normal_(p.w3, dense_std(e.n_experts), generator)
    if e.n_shared:
        init_mlp(p.shared, generator)
    return p


def _expert_ffn(buf, p: MoE, cfg):
    """buf: (E, C, D) -> (E, C, D); one batched product per weight."""
    h = ACTIVATIONS[cfg.mlp_act](torch.bmm(buf, p.w1))
    if cfg.gated_mlp:
        h = h * torch.bmm(buf, p.w3)
    return torch.bmm(h, p.w2)


def _dispatch_group(xt, disp, combine_logits, p: MoE, cfg, *, k: int,
                    capacity: int, experts: tuple | None = None):
    """Dispatch, expert FFN and combine for ONE token group.

    ``xt`` (T, D) tokens, ``disp`` (T, E) the router's decisions,
    ``combine_logits`` (T, E) the unrouted gate logits, whose softmax
    masked by ``disp`` weighs each expert's output (as the reference; the
    router's ``combine`` is not used). Each token's (at most k) experts
    are sorted stably by id and take capacity slots in token order; what
    is past an expert's capacity is dropped. Capacity slots live in an
    ``(E + 1, C, D)`` buffer whose last expert row takes the dropped
    writes, so no index is out of bounds. ``experts = (e0, n)``: only
    experts ``[e0, e0 + n)`` are held here (their weights ``p.w1`` ...),
    and the result is their part of the combine.
    """
    T, D = xt.shape
    E = cfg.moe.n_experts
    dev = xt.device
    gates = torch.softmax(torch.where(disp, combine_logits, -1e9), dim=-1)
    combine = torch.where(disp, gates, 0.0).to(xt.dtype)

    choice_e = torch.where(disp, torch.arange(E, device=dev), E)
    flat_e = torch.sort(choice_e, dim=-1).values[:, :k].reshape(-1)  # or E
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st = flat_e[order], flat_t[order]
    starts = torch.searchsorted(se, torch.arange(E + 1, device=dev))
    pos = torch.arange(T * k, device=dev) - starts[se]
    ok = (se < E) & (pos < capacity)
    se_c = torch.where(ok, se, E)                       # dropped -> row E
    pos_c = torch.where(ok, pos, 0)
    wts = torch.gather(combine[st], 1, se_c.clamp(max=E - 1)[:, None])

    if experts is None:
        buf = xt.new_zeros((E + 1, capacity, D))
        buf[se_c, pos_c] = xt[st]
        out_buf = _expert_ffn(buf[:E], p, cfg)
        keep = se_c.clamp(max=E - 1)                    # read in bounds
    else:           # this rank's experts; the rest go to the spare row
        e0, n = experts
        ok = ok & (se_c >= e0) & (se_c < e0 + n)
        mine = torch.where(ok, se_c - e0, n)
        buf = xt.new_zeros((n + 1, capacity, D))
        buf[mine, pos_c] = xt[st]
        out_buf = _expert_ffn(buf[:n], p, cfg)
        keep = mine.clamp(max=n - 1)
    gathered = out_buf[keep, pos_c]                     # (T*k, D)
    contrib = torch.where(ok[:, None], gathered * wts, 0.0)
    return xt.new_zeros((T, D)).index_add_(0, st, contrib)


def moe_capacity(cfg, n_tokens: int, decode: bool) -> int:
    """Tokens per expert in one group of ``n_tokens``: all of them in
    decode, else ``int(T * k / E * capacity_factor)`` clipped to [1, T]."""
    e = cfg.moe
    if decode:
        return n_tokens
    return min(max(1, int(n_tokens * e.top_k / e.n_experts
                          * e.capacity_factor)), n_tokens)


def moe_apply(p: MoE, x, cfg, decode: bool = False,
              shd: Sharder = NO_MESH):
    """x: (B, S, D) -> (B, S, D). Group-local capacity-padded dispatch.

    decode=True routes plain top-k with capacity == T (no truncation):
    capacity coupling across tokens would make decode disagree with the
    batched forward pass. Otherwise ``router="flow"`` routes with
    ``auction_route`` and ``"topk"`` with ``topk_route``, at
    ``moe_capacity`` of a group. The ``G = gcd(shd.data_groups, T)``
    groups are routed in one call of the router; on a mesh ``x`` is this
    rank's rows, one group.
    """
    e = cfg.moe
    B, S, D = x.shape
    E, k = e.n_experts, e.top_k
    # the reference's G = gcd(data_groups, T) over the whole batch; on a
    # mesh ``x`` is this rank's rows, which are one of those groups
    G = 1 if shd.mesh is not None else math.gcd(shd.data_groups, B * S)
    Tg = B * S // G
    capacity = moe_capacity(cfg, Tg, decode)

    xt = x.reshape(G, Tg, D)
    logits = p.gate(xt).float()                          # (G, Tg, E)
    # routing decisions are discrete: the routers see detached scores (the
    # reference's stop_gradient), so the gate gets its gradient only
    # through the combine softmax of _dispatch_group, which reads the live
    # logits. Every group's routing problem at once (the routers are
    # batch-polymorphic over the leading group axis)
    scores = logits.detach()
    if e.router == "flow" and not decode:
        routing = auction_route(scores, k, capacity, n_iters=e.router_iters)
    else:
        routing = topk_route(scores, k, capacity)

    experts, xin, lin = None, xt, logits
    if shd.tp(E):           # this rank's block of the experts
        n = E // shd.size("model")
        experts = (shd.axis("model").index * n, n)
        xin, lin = shd.enter(xt), shd.enter(logits)
    out = torch.stack([
        _dispatch_group(xin[g], routing.dispatch[g], lin[g], p, cfg, k=k,
                        capacity=capacity, experts=experts)
        for g in range(G)])
    if experts is not None:
        out = shd.reduce(out)
    if e.n_shared:
        out = out + mlp_apply(p.shared, xt, cfg, shd)
    return out.reshape(B, S, D)


def moe_aux_metrics(p: MoE, x, cfg) -> dict:
    """Load-balance diagnostics for benchmarks (not used in any loss):
    ``max_load``, ``routed`` (int32) and ``load_cv`` (float32)."""
    e = cfg.moe
    T = x.shape[0] * x.shape[1]
    logits = p.gate(x.reshape(T, -1)).float()
    capacity = max(1, int(T * e.top_k / e.n_experts * e.capacity_factor))
    r = (auction_route(logits, e.top_k, capacity) if e.router == "flow"
         else topk_route(logits, e.top_k, capacity))
    load = r.demand / torch.clamp_min(r.demand.sum(), 1)
    return {"max_load": r.demand.max(),
            "routed": r.dispatch.sum(dtype=torch.int32),
            "load_cv": load.std(correction=0)
            / torch.clamp_min(load.mean(), 1e-9)}
