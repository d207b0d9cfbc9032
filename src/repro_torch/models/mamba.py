"""Mamba2 (SSD, state-space duality) block: chunked prefill, recurrent
decode.

Counterpart of ``repro/models/mamba.py``. The prefill runs the SSD
chunked algorithm (Dao & Gu 2024): within a chunk the recurrence is a
masked quadratic form, across chunks a short scan passes the ``(H, P,
N)`` state. Decode keeps the state explicitly. One group: ``B`` and ``C``
are shared across heads, as in mamba2-370m.

The reference writes SSD as XLA ops and reaches no Pallas kernel, so this
module is plain PyTorch on both devices. The depthwise causal conv is
``d_conv`` shifted multiply-adds, as in the reference, not ``F.conv1d``:
on the card that would go to cuDNN, which rounds to TF32 unless told
otherwise. Every product here is a float32 ``einsum`` (cuBLAS, no TF32
while ``torch.backends.cuda.matmul.allow_tf32`` is off, its default).

The intra-chunk decay ``exp(-(cum_i - cum_j))`` subtracts two running
sums of up to ``chunk`` (256) terms of about 2 each, so how the cumulative
sum rounds moves each state by about 1e-4 of its size, and 48 layers
carry that to the logits. ``_cumsum`` therefore adds in the order of the
reference's cumsum on the CPU (XLA rewrites it into a tree of base 16:
sequential sums within blocks of 16, the blocks' totals scanned the same
way, then added back), the order the port's tests and the smoke's JAX
constants are made in; ``torch.cumsum`` adds in another (float64 on the
CPU, a float32 scan on the card).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (NO_MESH, Sharder, dense_std,
                                       depth_scaled_std, linear, normal_,
                                       rmsnorm)


class SSMCache(NamedTuple):
    state: torch.Tensor     # (B, H, P, N), float32
    conv: torch.Tensor      # (B, d_conv - 1, d_inner + 2 N): pre-conv inputs
    length: torch.Tensor    # tokens seen (0-d int32)


class Mamba(nn.Module):
    """The mamba mixer's parameters, the leaves of the JAX ``init_mamba``:
    ``in_proj`` ``(D, 2 di + 2 N + H)`` and ``out_proj`` ``(di, D)``
    (bias-free ``nn.Linear``, weights the JAX matrices transposed),
    ``conv_w`` ``(d_conv, di + 2 N)`` and ``conv_b`` in the JAX layout,
    ``A_log``, ``dt_bias``, ``D`` ``(H,)`` and the gated norm's gain
    ``norm_g`` ``(di,)``."""
    AXES = {"in_proj.weight": ("tp", "fsdp"), "conv_w": (None, "tp"),
            "conv_b": ("tp",), "A_log": (None,), "dt_bias": (None,),
            "D": (None,), "norm_g": ("tp",), "out_proj.weight": ("fsdp", "tp")}

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        s, D = cfg.ssm, cfg.d_model
        di, N, H = s.d_inner(D), s.d_state, s.n_heads(D)
        conv_dim = di + 2 * N
        self.cfg = cfg

        def vec(n, fill):
            return nn.Parameter(torch.full((n,), fill, device=device,
                                           dtype=dtype))
        self.in_proj = linear(D, 2 * di + 2 * N + H, device, dtype)
        self.conv_w = nn.Parameter(torch.empty(s.d_conv, conv_dim,
                                               device=device, dtype=dtype))
        self.conv_b = vec(conv_dim, 0.0)
        self.A_log = vec(H, 1.0)
        self.dt_bias = vec(H, 0.0)
        self.D = vec(H, 1.0)
        self.norm_g = vec(di, 1.0)
        self.out_proj = linear(di, D, device, dtype)

    def forward(self, x, *, positions=None, cache=None, decode: bool,
                shd: Sharder = NO_MESH):
        """``positions`` is taken for the mixers' common signature and not
        used: the SSM has no positional input."""
        return mamba_apply(self, x, self.cfg, shd, cache=cache, decode=decode)


def init_mamba(p: Mamba, generator: torch.Generator) -> Mamba:
    """Draw ``p``'s weights from ``generator`` with the JAX
    ``init_mamba``'s stds: ``in_proj`` ``d_model ** -0.5``, ``conv_w``
    ``d_conv ** -0.5``, ``out_proj`` ``di ** -0.5 / (2 n_layers) ** 0.5``
    (``ParamFactory.dense``'s ``scale`` replaces the fan-in std); ``A_log``,
    ``D`` and ``norm_g`` ones, ``dt_bias`` and ``conv_b`` zeros."""
    cfg = p.cfg
    s = cfg.ssm
    normal_(p.in_proj.weight, dense_std(cfg.d_model), generator)
    normal_(p.conv_w, s.d_conv ** -0.5, generator)
    normal_(p.out_proj.weight,
            depth_scaled_std(s.d_inner(cfg.d_model), cfg.n_layers), generator)
    with torch.no_grad():
        for one in (p.A_log, p.D, p.norm_g):
            one.fill_(1.0)
        for zero in (p.dt_bias, p.conv_b):
            zero.zero_()
    return p


def _causal_conv(u, w, b, cache_conv=None):
    """Depthwise causal conv1d and SiLU. u: (B, S, C); w: (K, C).

    Prefill pads ``K - 1`` zeros in front and returns the last ``K - 1``
    pre-conv inputs (the zero pad among them where ``S < K - 1``); decode
    (``S == 1``) takes them from ``cache_conv`` and returns the window
    shifted by one. The reference pads ``min(S, K - 1)`` zeros
    (``zeros_like(u[:, :K - 1])``), which is the same for ``S >= K - 1``
    and wrong below it (an empty output at ``S == 1``, broadcast terms at
    ``S == 2`` for ``K = 4``); the port pads ``K - 1`` at every length."""
    K = w.shape[0]
    if cache_conv is not None:                    # decode: S == 1
        window = torch.cat([cache_conv, u], dim=1)            # (B, K, C)
        out = sum(window[:, i] * w[i] for i in range(K))[:, None] + b
        return F.silu(out), window[:, 1:]
    Bsz, S, C = u.shape
    up = torch.cat([u.new_zeros((Bsz, K - 1, C)), u], dim=1)
    out = sum(up[:, i:i + S] * w[i] for i in range(K)) + b
    return F.silu(out), up[:, -(K - 1):] if K > 1 else None


SCAN_BASE = 16    # the block length of XLA's CPU cumulative-sum rewrite


def _sequential_scan(x):
    """Inclusive running sum over the last axis, one add after another."""
    out = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., i])
    return torch.stack(out, dim=-1)


def _tree_scan(x):
    n = x.shape[-1]
    if n <= SCAN_BASE:
        return _sequential_scan(x)
    blocks = F.pad(x, (0, -n % SCAN_BASE)).reshape(
        *x.shape[:-1], -1, SCAN_BASE)
    blocks = _sequential_scan(blocks)
    before = F.pad(_tree_scan(blocks[..., -1])[..., :-1], (1, 0))
    return (blocks + before[..., None]).reshape(*x.shape[:-1], -1)[..., :n]


def _cumsum(x, dim: int):
    """Inclusive cumulative sum along ``dim``, rounded as the reference's
    ``jnp.cumsum`` on the CPU (bit for bit on the same float32 inputs):
    sequential within blocks of SCAN_BASE, the blocks' totals scanned the
    same way and added to the next block."""
    return _tree_scan(x.movedim(dim, -1)).movedim(-1, dim)


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk, init_state=None):
    """SSD scan. xh: (B,S,H,P); dt: (B,S,H); A: (H,); Bm/Cm: (B,S,N).

    Returns (y: (B,S,H,P), final_state: (B,H,P,N)). Raises where ``S`` is
    not a multiple of ``chunk`` (the reference asserts; nothing is
    padded).
    """
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the SSD "
                         f"chunk {chunk}")
    nc = S // chunk

    # per-step decay: a_t = exp(-dt_t * A); work with the positive exponent
    dA = dt * A[None, None, :]                    # (B,S,H) >= 0
    dA_c = dA.reshape(Bsz, nc, chunk, H)
    x_c = xh.reshape(Bsz, nc, chunk, H, P)
    dt_c = dt.reshape(Bsz, nc, chunk, H)
    B_c = Bm.reshape(Bsz, nc, chunk, N)
    C_c = Cm.reshape(Bsz, nc, chunk, N)

    cum = _cumsum(dA_c, dim=2)                    # (B,nc,Q,H) inclusive
    total = cum[:, :, -1]                         # (B,nc,H)
    # intra-chunk quadratic term: x_j's weight in h_i is prod_{l=j+1..i} a_l
    # = exp(-(cum_i - cum_j)) for i >= j (own-step input is not decayed)
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,Q,H)
    iq = torch.arange(chunk, device=xh.device)
    causal = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    # clamp BEFORE exp, as the reference: masked entries have li < 0, and
    # exp(-li) = inf there would turn into NaN in a gradient
    li = torch.where(causal, li, 0.0)
    L = torch.where(causal, torch.exp(-li), 0.0)
    scores = torch.einsum("bcin,bcjn->bcij", C_c, B_c)[..., None] * L \
        * dt_c[:, :, None, :, :]                  # (B,nc,Q,Q,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, x_c)

    # chunk-final states: sum_j exp(-(total - cum_j)) * dt_j * B_j x_j
    decay_to_end = torch.exp(cum - total[:, :, None])      # (B,nc,Q,H)
    st = torch.einsum("bcqh,bcqn,bcqhp->bchpn",
                      decay_to_end * dt_c, B_c, x_c)       # per-chunk state

    # scan across chunks: h_c = h_{c-1} * exp(-total_c) + st_c, keeping
    # each chunk's PRE-chunk state
    h = init_state if init_state is not None else \
        torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * torch.exp(-total[:, c])[:, :, None, None] + st[:, c].float()
    h_prev = torch.stack(prev, dim=1)             # (B,nc,H,P,N) pre-chunk

    # inter-chunk contribution: y_i += C_i . (exp(-cum_i) * h_prev)
    decay_from_start = torch.exp(-cum)            # h_{-1} decayed through i
    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp",
                           C_c, decay_from_start, h_prev.to(C_c.dtype))
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y, h


def mamba_apply(p: Mamba, x, cfg, shd: Sharder = NO_MESH, *,
                cache: Optional[SSMCache] = None, decode: bool = False):
    """Returns (out, new_cache). Prefill (``decode=False``) starts from a
    zero state and returns a new ``SSMCache`` only where a cache was
    given (its contents are not read); decode takes one token and the
    cache.

    One path for one card and a mesh. On a model axis of m ranks (rank r;
    every collective below the identity where m is 1) each leaf keeps the
    reference's placement, split where m divides its ``"tp"`` dim:
    ``in_proj``'s columns cut the concatenation ``[z | x | B | C | dt]``
    evenly, which does not line up with heads, so each rank multiplies its
    block and the ranks gather the whole activation. Each then runs the
    depthwise conv on its block of the ``C = di + 2 N`` channels of
    ``xbc`` (those of its ``conv_w``, ``conv_b`` and conv cache) and the
    ranks gather the result. Where m divides the H heads, rank r runs
    heads ``[r H / m, (r + 1) H / m)``, exactly its block of ``di`` (that
    of ``norm_g`` and ``out_proj``'s rows): the prefill's chunked SSD on
    them, the state gathered once into the cache's whole-over-``model``
    leaf; decode updates every head's state (a few elementwise ops on the
    gathered ``xbc`` and ``dt``, so the whole state stays current with no
    gather) and reads out the rank's. The gate ``y * silu(z)`` is the
    rank's block of ``di``, the gated RMSNorm's sum of squares an
    all-reduce, and the ranks' ``out_proj`` partials are summed. Where m
    does not divide H every rank runs every head, and takes its block of
    the normed output where m divides ``di``."""
    s, D = cfg.ssm, cfg.d_model
    di, N, H, P = s.d_inner(D), s.d_state, s.n_heads(D), s.head_dim
    C = di + 2 * N
    B, S, _ = x.shape
    m, r = shd.size("model"), shd.axis("model").index
    heads = shd.tp(H)           # this rank's heads: its block of di
    Hl = H // m if heads else H
    h0 = r * Hl if heads else 0
    in_split, conv_split = shd.tp(2 * di + 2 * N + H), shd.tp(C)

    def mine(t, dim, lo, n):
        """``t``'s block ``[lo, lo + n)`` of ``dim`` for this rank's heads
        (``enter``: its gradient summed over the ranks)."""
        return shd.enter(t, dim, lo, n) if heads else t.narrow(dim, lo, n)

    zxbcdt = p.in_proj(shd.enter(x) if in_split else x)
    if in_split:
        zxbcdt = shd.gather(zxbcdt, -1)
    z, xbc, dt_raw = torch.split(zxbcdt, [di, C, H], dim=-1)

    if decode and (cache is None or S != 1):
        raise ValueError("decode takes one token and a cache")
    if conv_split:              # this rank's channels
        xbc = shd.enter(xbc, -1, r * (C // m), C // m)
    xbc, new_conv = _causal_conv(xbc, p.conv_w, p.conv_b,
                                 cache.conv if decode else None)
    if conv_split:
        xbc = shd.gather(xbc, -1)

    if decode:                  # every head's state, this rank's output
        xh, Bm, Cm = torch.split(xbc, [di, N, N], dim=-1)
        xh = xh.reshape(B, S, H, P)
        dt = F.softplus(dt_raw.float() + p.dt_bias)
        A = torch.exp(p.A_log.float())                        # (H,) positive
        dA = torch.exp(-dt[:, 0] * A[None, :])                # (B,H)
        upd = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], Bm[:, 0].float(),
                           xh[:, 0].float())
        h_new = cache.state * dA[:, :, None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(),
                         h_new[:, h0:h0 + Hl])[:, None]       # (B,1,Hl,P)
        xh = xh[:, :, h0:h0 + Hl]
        new_cache = SSMCache(h_new, new_conv, cache.length + 1)
    else:
        xh = mine(xbc, -1, h0 * P, Hl * P).reshape(B, S, Hl, P)
        Bm, Cm = torch.split(mine(xbc, -1, di, 2 * N), [N, N], dim=-1)
        dt = F.softplus(mine(dt_raw, -1, h0, Hl).float()
                        + mine(p.dt_bias, 0, h0, Hl))
        A = torch.exp(mine(p.A_log, 0, h0, Hl).float())       # positive
        y, hT = _ssd_chunked(xh.float(), dt, A, Bm.float(), Cm.float(),
                             min(s.chunk, S))
        new_cache = SSMCache(shd.gather(hT, 1) if heads else hT, new_conv,
                             torch.tensor(S, dtype=torch.int32,
                                          device=x.device)) \
            if cache is not None else None

    y = y + xh.float() * mine(p.D, 0, h0, Hl)[None, None, :, None]
    y = y.reshape(B, S, Hl * P).to(x.dtype) * F.silu(
        mine(z, -1, h0 * P, Hl * P))
    if heads:       # the gated RMSNorm over di: the ranks' sums of squares
        y32 = y.float()
        ss = shd.enter(shd.reduce(torch.sum(y32 * y32, -1, keepdim=True)))
        y = (y32 * torch.rsqrt(ss / di + 1e-6)).to(x.dtype) * p.norm_g
        return shd.reduce(p.out_proj(y)), new_cache
    if shd.tp(di):  # every head here, norm_g and out_proj's rows split
        n = di // m
        y = shd.enter(rmsnorm(y, 1.0), -1, r * n, n) * p.norm_g
        return shd.reduce(p.out_proj(y)), new_cache
    return p.out_proj(rmsnorm(y, p.norm_g)), new_cache
