"""Attention: GQA (+RoPE, qk-norm) and DeepSeek's MLA, prefill and decode.

Counterpart of ``repro/models/attention.py``. Prefill runs the causal,
GQA, online-softmax forward: on the card that is K6
(``kernels/flash_attention``, the kernel the JAX package wrote to replace
its ``_flash_fwd_scan``), on the CPU the plain chunked scan
``_flash_fwd_scan`` below. MLA's prefill expands the compressed keys and
values per head and goes through the same forward (qk width nope + rope,
v width ``v_dim``). Where autograd tracks an input (training), prefill
goes through ``_FlashCore``, the counterpart of the JAX package's
``_flash_core`` custom VJP: its forward is K6 on the card (which also
writes each row's log-sum-exp) or the plain scan on the CPU, and its
backward is ``_flash_core_bwd`` in plain PyTorch, recomputing the
probabilities per key chunk from ``(q, k, v, out, lse)``. Decode scores
one query against the whole cache with plain tensor ops, as in the JAX
package; MLA's decode is the absorbed form, scored against the
compressed cache ``c_kv`` and the shared rope keys directly, never
expanding them.

The caches are updated in place (the JAX package's
``dynamic_update_slice`` makes a new buffer): prefill writes the prompt's
keys and values (MLA: ``c_kv`` and ``k_rope``) into the ``S_max``
buffers, decode writes one position at ``cache.length`` (clamped into the
buffer, as ``dynamic_update_slice`` clamps), and the returned ``KVCache``
shares their storage.

With ``cfg.kv_quant`` the GQA cache is ``KVCacheQ``: int8 codes and one
float32 scale per (request, position, kv head), ``_quant_kv``'s
symmetric rounding. Prefill quantises the prompt's keys and values into
it; decode quantises the new row, writes it at ``cache.length`` and
scores against the whole cache dequantised (``codes * scale``), as the
JAX package does. Attention runs non-causal (the encoder) wherever
``cfg.causal`` is False: K6 and the plain scan skip the mask, and so does
the backward.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.models.layers import (NO_MESH, Sharder, apply_rope,
                                       dense_std, depth_scaled_std, linear,
                                       normal_, rmsnorm)

NEG_INF = -1e30
KV_CHUNK = 512          # the plain scan's key chunk (the JAX kv_chunk)


class KVCache(NamedTuple):
    k: torch.Tensor     # GQA: (B, S_max, KV, dh) | MLA: c_kv (B, S_max, kv_lora)
    v: torch.Tensor     # GQA: (B, S_max, KV, dh) | MLA: k_rope (B, S_max, rope)
    length: torch.Tensor    # filled prefix length (0-d int32)


class KVCacheQ(NamedTuple):
    """The int8 GQA cache: per-vector symmetric scales, one float32 per
    (b, s, kv head)."""
    k_q: torch.Tensor       # (B, S_max, KV, dh) int8
    k_s: torch.Tensor       # (B, S_max, KV, 1) float32
    v_q: torch.Tensor       # (B, S_max, KV, dh) int8
    v_s: torch.Tensor       # (B, S_max, KV, 1) float32
    length: torch.Tensor    # filled prefix length (0-d int32)


def _quant_kv(x):
    """``(codes int8, scales float32)`` of ``x`` over its last axis: ``s =
    max|x| / 127`` (keepdims) and ``round(x / max(s, 1e-9))``, half to
    even as ``jnp.round``. Both divisions take a tensor on ``x``'s device,
    never a host scalar, which the card would turn into a product with
    its reciprocal (one ulp off a true quotient)."""
    x32 = x.float()
    m = x32.abs().amax(-1, keepdim=True)
    s = m / m.new_full((), 127.0)
    q = torch.round(x32 / torch.clamp_min(s, 1e-9)).to(torch.int8)
    return q, s


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

class GQA(nn.Module):
    """The GQA mixer's parameters: ``wq``, ``wk``, ``wv``, ``wo`` (bias-free
    ``nn.Linear``, weights the JAX matrices transposed) and, with
    ``cfg.qk_norm``, the RMSNorm gains ``q_g`` and ``k_g``."""
    # the reference's logical axes, transposed into nn.Linear's (out, in)
    AXES = {"wq.weight": ("tp", "fsdp"), "wk.weight": ("tp", "fsdp"),
            "wv.weight": ("tp", "fsdp"), "wo.weight": ("fsdp", "tp"),
            "q_g": (None,), "k_g": (None,)}

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        dh, H, KV, D = cfg.dh, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
        self.cfg = cfg
        self.wq = linear(D, H * dh, device, dtype)
        self.wk = linear(D, KV * dh, device, dtype)
        self.wv = linear(D, KV * dh, device, dtype)
        self.wo = linear(H * dh, D, device, dtype)
        if cfg.qk_norm:
            self.q_g = nn.Parameter(torch.ones(dh, device=device, dtype=dtype))
            self.k_g = nn.Parameter(torch.ones(dh, device=device, dtype=dtype))

    def forward(self, x, *, positions, cache=None, decode: bool,
                shd: Sharder = NO_MESH):
        return gqa_apply(self, x, self.cfg, shd, positions=positions,
                         cache=cache, decode=decode)


def init_gqa(p: GQA, generator: torch.Generator) -> GQA:
    """Draw ``p``'s weights from ``generator`` with the JAX ``init_gqa``'s
    stds: ``fan_in ** -0.5``, ``wo`` depth-scaled (gains stay 1)."""
    cfg = p.cfg
    for w in (p.wq, p.wk, p.wv):
        normal_(w.weight, dense_std(cfg.d_model), generator)
    normal_(p.wo.weight, depth_scaled_std(cfg.n_heads * cfg.dh, cfg.n_layers),
            generator)
    return p


def _causal_penalty(pos_q, start: int, n: int):
    """The additive causal mask of keys ``[start, start + n)``:
    ``(1, 1, Sq, n)``, 0 where ``pos_q >= pos_k``, else ``NEG_INF``."""
    pos_k = start + torch.arange(n, device=pos_q.device)
    return torch.where(pos_q[:, None] >= pos_k[None, :], 0.0,
                       NEG_INF)[None, None]


def _flash_fwd_scan(q, k, v, causal, scale, chunk):
    """Online-softmax forward over key chunks, the plain version of the
    prefill attention. Returns (out32 ``(B, H, Sq, dv)``, lse ``(B, H, Sq)``).

    The JAX package's scan in the same operation order: the products take
    bfloat16 operands for bfloat16 inputs (exact in float32, so they run in
    float32 here) with float32 accumulation, the causal mask is an
    additive ``NEG_INF`` penalty, and only the softmax statistics are
    float32 throughout.
    """
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    G = H // KV
    cdt = q.dtype if q.dtype == torch.bfloat16 else torch.float32
    dev = q.device
    pos_q = torch.arange(Sq, device=dev)
    qc = q.to(cdt).float()
    acc = torch.zeros((B, H, Sq, dv), dtype=torch.float32, device=dev)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    for start in range(0, Sk, chunk):      # a shorter last chunk: any Sk
        sl = slice(start, start + chunk)
        kb = k[:, sl].repeat_interleave(G, 2).to(cdt).float()
        vb = v[:, sl].repeat_interleave(G, 2).to(cdt).float()
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kb) * scale
        if causal:
            s = s + _causal_penalty(pos_q, start, kb.shape[1])
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(cdt).float(), vb)
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return acc / l[..., None], m + torch.log(l)


def _flash_core_bwd(causal, scale, chunk, res, dout):
    """The JAX ``_flash_core_bwd`` in its operation order: per key chunk,
    recompute ``p = exp(s - lse)``, accumulate ``dq`` and emit the chunk's
    ``dk`` and ``dv``, summed over the ``G`` query heads of each kv head.
    ``res`` is ``(q, k, v, out32 (B, H, Sq, dv), lse (B, H, Sq))``. The
    products take bfloat16 operands for bfloat16 inputs and accumulate in
    float32, as the forward's. A shorter last chunk is allowed."""
    q, k, v, out32, lse = res
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    G = H // KV
    cdt = q.dtype if q.dtype == torch.bfloat16 else torch.float32
    qc = q.to(cdt).float()
    do32 = dout.float().transpose(1, 2)                   # (B,H,Sq,dv)
    doc = do32.to(cdt).float()
    delta = torch.sum(do32 * out32, dim=-1)               # (B,H,Sq)
    pos_q = torch.arange(Sq, device=q.device)
    dq = torch.zeros((B, Sq, H, dh), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for start in range(0, Sk, chunk):
        sl = slice(start, start + chunk)
        kbf = k[:, sl].repeat_interleave(G, 2).to(cdt).float()
        vbf = v[:, sl].repeat_interleave(G, 2).to(cdt).float()
        n = kbf.shape[1]
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kbf) * scale
        if causal:
            s = s + _causal_penalty(pos_q, start, n)
        p = torch.exp(s - lse[..., None])                 # (B,H,Sq,C) f32
        pc = p.to(cdt).float()
        dv_c = torch.einsum("bhqk,bhqd->bkhd", pc, doc)
        dp = torch.einsum("bhqd,bkhd->bhqk", doc, vbf)
        ds = (p * (dp - delta[..., None]) * scale).to(cdt).float()
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kbf)
        dk_c = torch.einsum("bhqk,bqhd->bkhd", ds, qc)
        dks.append(dk_c.reshape(B, n, KV, G, dh).sum(3))
        dvs.append(dv_c.reshape(B, n, KV, G, dv).sum(3))
    return (dq.to(q.dtype), torch.cat(dks, 1).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype))


class _FlashCore(torch.autograd.Function):
    """The JAX ``_flash_core`` custom VJP. Forward: K6 on a CUDA tensor
    (with its log-sum-exp output), the plain scan on a CPU one; returns
    ``(out (B, Sq, H, dv), lse (B, H, Sq))``, ``lse`` not differentiable.
    Backward: ``_flash_core_bwd``, plain PyTorch on either device, from
    the saved ``(q, k, v, out32, lse)``; a bfloat16 ``out`` of K6 enters
    it as float32 of the rounded values, where the scan keeps its float32
    accumulator."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, chunk: int):
        ctx.on_card = _build.card_branch(q)
        if ctx.on_card:     # K6's output itself is the residual
            out, lse = flash_attention_op(q, k, v, causal=causal,
                                          scale=scale, return_lse=True)
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            out32, lse = _flash_fwd_scan(q, k, v, causal, scale, chunk)
            out = out32.transpose(1, 2).to(q.dtype)
            ctx.save_for_backward(q, k, v, out32, lse)
        ctx.args = (causal, scale, chunk)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        out32 = out.float().transpose(1, 2) if ctx.on_card else out
        dq, dk, dv = _flash_core_bwd(*ctx.args, (q, k, v, out32, lse), dout)
        return dq, dk, dv, None, None, None


def flash_core(q, k, v, *, causal: bool = True, scale: float | None = None,
               chunk: int = KV_CHUNK, return_lse: bool = False):
    """Differentiable attention forward (``_FlashCore``): q ``(B, Sq, H,
    dh)``, k / v ``(B, Sk, KV, ·)``; ``scale`` defaults to ``dh ** -0.5``
    and ``chunk`` (the backward's key chunk, and the CPU scan's) is cut to
    ``Sk``. Returns ``(B, Sq, H, dv)``, and with ``return_lse`` also the
    log-sum-exp ``(B, H, Sq)``."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    out, lse = _FlashCore.apply(q, k, v, causal, scale,
                                min(chunk, k.shape[1]))
    return (out, lse) if return_lse else out


def _flash_attend(q, k, v, *, causal: bool, scale: float, chunk: int):
    """Prefill attention. q: (B,Sq,H,dh); k/v: (B,Sk,KV,·) -> (B,Sq,H,dv).

    Where autograd tracks an input, ``_FlashCore`` (K6 or the scan
    forward, the plain backward); otherwise K6 on a CUDA tensor, the plain
    scan on a CPU one. ``chunk`` is the scan's key chunk; the JAX package
    requires ``Sk % min(chunk, Sk) == 0`` and so does the port, on every
    path, so the same prompts fail in both.
    """
    Sk = k.shape[1]
    chunk = min(chunk, Sk)
    if Sk % chunk:
        raise ValueError(f"key length {Sk} is not a multiple of the "
                         f"attention chunk {chunk}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashCore.apply(q, k, v, causal, scale, chunk)[0]
    if _build.card_branch(q):
        return flash_attention_op(q, k, v, causal=causal, scale=scale)
    out, _ = _flash_fwd_scan(q, k, v, causal, scale, chunk)
    return out.transpose(1, 2).to(q.dtype)


def _seq_block(cache, shd: Sharder) -> tuple[int, int, bool]:
    """``(first position, positions, split)`` of this rank's block of a
    cache's sequence: the whole of it unless its spec splits it over a
    model axis above 1."""
    T = cache[0].shape[1]
    spec = getattr(cache[0], "spec", None)
    i, n = shd.block(spec[1]) if spec is not None else (0, 1)
    return i * T, T, n > 1


def _write_decode(cache, rows, shd: Sharder):
    """Decode: each of ``rows`` (one position) written into its buffer of
    ``cache`` at ``cache.length``, clamped into the buffer as
    ``dynamic_update_slice`` clamps the start; on a split sequence only
    the rank holding that position writes it (a masked write, no host
    sync). Returns the buffers and ``_seq_block``'s ``(first position,
    positions, split)``."""
    c0, Tl, split = _seq_block(cache, shd)
    T = Tl * shd.size("model") if split else Tl
    at = cache.length.clamp(max=T - 1).long().reshape(1) - c0
    if split:
        own = ((at >= 0) & (at < Tl)).reshape(())
        at = at.clamp(0, Tl - 1)
    bufs = cache[:len(rows)]
    for buf, row in zip(bufs, rows):
        row = row.to(buf.dtype)
        if split:
            row = torch.where(own, row, buf.index_select(1, at))
        buf.index_copy_(1, at, row)
    return bufs, (c0, Tl, split)


def _write_prompt(cache, rows, shd: Sharder):
    """Prefill: the prompt's ``rows`` ``(B, S, ...)`` written at this
    rank's positions of ``cache``'s buffers. Returns the new cache (the
    same buffers, length S)."""
    c0, Tl, split = _seq_block(cache, shd)
    T = Tl * shd.size("model") if split else Tl
    S = rows[0].shape[1]
    if S > T:
        raise ValueError(f"a prompt of {S} tokens does not fit a cache of "
                         f"{T}")
    n = max(0, min(S - c0, Tl))
    for buf, row in zip(cache, rows):
        buf[:, :n] = row[:, c0:c0 + n].to(buf.dtype)
    return type(cache)(*cache[:len(rows)], torch.tensor(
        S, dtype=torch.int32, device=rows[0].device))


def gqa_apply(p: GQA, x, cfg, shd: Sharder = NO_MESH, *, positions,
              cache: Optional[KVCache | KVCacheQ] = None, decode: bool):
    """Returns (out, new_cache). Prefill: decode=False (cache optional).
    A ``KVCacheQ`` cache is written with ``_quant_kv``'s codes and scales
    and read dequantised.

    One path for one card and a mesh. On a model axis of m ranks (rank r;
    m = 1 on one card, where every collective below is the identity and
    no masked write is made) the weights' ``"tp"`` dims are split where m
    divides them (``Sharder.tp``), as placed.

    Heads. Where m divides H (the reference's constraint of q's heads)
    rank r runs heads ``[r H / m, (r + 1) H / m)``: its block of ``wq``'s
    columns is exactly theirs, and it takes the kv heads of their groups.
    Where m also divides KV, its block of ``wk`` / ``wv`` is exactly those
    kv heads; otherwise (phi on 16 ranks: 8 kv heads, 2 q heads a rank) the
    keys and values are made whole (gathered where their columns are split)
    and the rank takes its block of kv heads, ``enter``ed. K6 then runs on
    the rank's ``(B, S, H / m, dh)`` queries against its kv heads, each
    query head still reading the kv head ``h // (H / KV)`` reads in the
    whole launch. Where m does not divide H (smollm's 9 heads on 16
    ranks) every rank runs every head, on queries gathered from its block
    of columns. ``wo``'s rows follow q's columns: each rank multiplies its
    block and the ranks' partial outputs are summed (``reduce``).

    Caches hold every kv head; the sequence is split over ``model`` where
    m divides ``S_max`` (spec ``"seq"``), else whole on every rank. The
    prompt's rows go to the rank that holds their positions, as does
    each decode step's new row (on a split sequence a masked write at the
    position, no host sync). Decode against a split sequence is a
    flash-decoding combine: every rank scores every head (the queries
    gathered) against its positions, the ranks agree on each row's
    maximum (all-reduce max) and sum the exponentials and their products
    with the values (one all-reduce); against a whole cache each rank
    attends its own heads."""
    B, S, D = x.shape
    dh, H, KV = cfg.dh, cfg.n_heads, cfg.n_kv_heads
    G = H // KV
    m, r = shd.size("model"), shd.axis("model").index
    q_split, kv_split = shd.tp(H * dh), shd.tp(KV * dh)
    heads = H % m == 0
    Hl = H // m if heads else H
    h0 = r * Hl if heads else 0
    kv_local = kv_split and heads and KV % m == 0
    if heads and Hl % G and G % Hl:
        raise NotImplementedError(f"{Hl} query heads a rank straddle the "
                                  f"groups of {G}")
    kv0, nkv = (h0 // G, max(Hl // G, 1)) if heads else (0, KV)
    xin = shd.enter(x) if (q_split or kv_split) else x
    q = p.wq(xin if q_split else x)
    if q_split and not heads:
        q = shd.gather(q, -1)
    k, v = p.wk(xin if kv_split else x), p.wv(xin if kv_split else x)
    if kv_split and not kv_local:
        k, v = shd.gather(k, -1), shd.gather(v, -1)
    q = q.reshape(B, S, Hl, dh)
    k = k.reshape(B, S, -1, dh)
    v = v.reshape(B, S, -1, dh)
    if cfg.qk_norm:
        q, k = rmsnorm(q, p.q_g), rmsnorm(k, p.k_g)
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    scale = dh ** -0.5
    quant = isinstance(cache, KVCacheQ)

    def whole(t):           # every kv head (the caches hold them all)
        return shd.gather(t, 2) if kv_local else t

    if cache is not None:
        rows = (*_quant_kv(whole(k)), *_quant_kv(whole(v))) if quant \
            else (whole(k), whole(v))
    if decode:
        if cache is None or S != 1:
            raise ValueError("decode takes one token and a cache")
        bufs, (c0, Tl, split) = _write_decode(cache, rows, shd)
        if quant:
            kc = cache.k_q.float() * cache.k_s
            vc = cache.v_q.float() * cache.v_s
        else:
            kc, vc = cache.k.float(), cache.v.float()
        new_cache = type(cache)(*bufs, cache.length + 1)
        valid = c0 + torch.arange(Tl, device=x.device) <= cache.length
        if split:
            qa = shd.gather(q, 2) if heads else q      # every head
            qg = qa.float().reshape(B, 1, KV, G, dh)
            s = torch.einsum("bqkgd,btkd->bkgqt", qg, kc) * scale
            s = torch.where(valid, s, NEG_INF)
            mx = shd.all_max(s.amax(-1, keepdim=True))
            pr = torch.exp(s - mx)
            part = torch.cat([torch.einsum("bkgqt,btkd->bqkgd", pr, vc),
                              pr.sum(-1).permute(0, 3, 1, 2)[..., None]], -1)
            part = shd.reduce(part)
            o = (part[..., :dh] / part[..., dh:]).reshape(B, 1, H * dh)
            if heads:
                o = o[..., h0 * dh:(h0 + Hl) * dh]
        else:       # grouped score: q as (B, 1, kv heads, group, dh)
            kc, vc = kc[:, :, kv0:kv0 + nkv], vc[:, :, kv0:kv0 + nkv]
            qg = q.float().reshape(B, 1, nkv, Hl // nkv, dh)
            s = torch.einsum("bqkgd,btkd->bkgqt", qg, kc) * scale
            s = torch.where(valid, s, NEG_INF)    # includes the new token
            pr = torch.softmax(s, dim=-1)
            o = torch.einsum("bkgqt,btkd->bqkgd", pr, vc)
            o = o.reshape(B, 1, Hl * dh)
        o = o.to(x.dtype)
    else:
        if kv_local or not heads or m == 1:
            kq, vq = k, v
        else:
            kq, vq = shd.enter(k, 2, kv0, nkv), shd.enter(v, 2, kv0, nkv)
        o = _flash_attend(q, kq, vq, causal=cfg.causal, scale=scale,
                          chunk=KV_CHUNK).reshape(B, S, Hl * dh)
        new_cache = None if cache is None else _write_prompt(cache, rows,
                                                             shd)
    if heads:
        return shd.reduce(p.wo(o)), new_cache
    if q_split:         # every head here, wo's rows split
        n = H * dh // m
        return shd.reduce(p.wo(shd.enter(o, -1, r * n, n))), new_cache
    return p.wo(o), new_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank KV compression; absorbed decode
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """The MLA mixer's parameters: ``wq_a``, ``wq_b``, ``wkv_a``, ``wo``
    (bias-free ``nn.Linear``, weights the JAX matrices transposed), the
    RMSNorm gains ``q_norm`` and ``kv_norm``, and the per-head expansions
    ``wk_b`` ``(kv_lora, H, nope)`` and ``wv_b`` ``(kv_lora, H, v)`` in
    the JAX layout."""
    AXES = {"wq_a.weight": (None, "fsdp"), "q_norm": (None,),
            "wq_b.weight": ("tp", None), "wkv_a.weight": (None, "fsdp"),
            "kv_norm": (None,), "wk_b": (None, "tp", None),
            "wv_b": (None, "tp", None), "wo.weight": ("fsdp", "tp")}

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        m, D, H = cfg.mla, cfg.d_model, cfg.n_heads
        qd = m.qk_nope_dim + m.qk_rope_dim
        self.cfg = cfg

        def param(*shape, fill=None):
            t = torch.empty(shape, device=device, dtype=dtype)
            return nn.Parameter(t if fill is None else t.fill_(fill))
        self.wq_a = linear(D, m.q_lora_rank, device, dtype)
        self.q_norm = param(m.q_lora_rank, fill=1.0)
        self.wq_b = linear(m.q_lora_rank, H * qd, device, dtype)
        self.wkv_a = linear(D, m.kv_lora_rank + m.qk_rope_dim, device, dtype)
        self.kv_norm = param(m.kv_lora_rank, fill=1.0)
        self.wk_b = param(m.kv_lora_rank, H, m.qk_nope_dim)
        self.wv_b = param(m.kv_lora_rank, H, m.v_dim)
        self.wo = linear(H * m.v_dim, D, device, dtype)

    def forward(self, x, *, positions, cache=None, decode: bool,
                shd: Sharder = NO_MESH):
        return mla_apply(self, x, self.cfg, shd, positions=positions,
                         cache=cache, decode=decode)


def init_mla(p: MLA, generator: torch.Generator) -> MLA:
    """Draw ``p``'s weights from ``generator`` with the JAX ``init_mla``'s
    stds. ``ParamFactory.dense`` takes ``fan_in = shape[0]``: ``wq_a`` and
    ``wkv_a`` get ``d_model ** -0.5``, ``wq_b`` ``q_lora ** -0.5``,
    ``wk_b`` and ``wv_b`` ``kv_lora ** -0.5``; ``wo`` is depth-scaled
    (gains stay 1)."""
    cfg = p.cfg
    m = cfg.mla
    normal_(p.wq_a.weight, dense_std(cfg.d_model), generator)
    normal_(p.wq_b.weight, dense_std(m.q_lora_rank), generator)
    normal_(p.wkv_a.weight, dense_std(cfg.d_model), generator)
    normal_(p.wk_b, dense_std(m.kv_lora_rank), generator)
    normal_(p.wv_b, dense_std(m.kv_lora_rank), generator)
    normal_(p.wo.weight, depth_scaled_std(cfg.n_heads * m.v_dim,
                                          cfg.n_layers), generator)
    return p


def mla_apply(p: MLA, x, cfg, shd: Sharder = NO_MESH, *, positions,
              cache: Optional[KVCache] = None, decode: bool):
    """Returns (out, new_cache). Prefill: decode=False (cache optional).

    The JAX ``mla_apply``'s operation order. The scale is that of the
    query-key width, ``(nope + rope) ** -0.5``, not ``cfg.dh``'s; RoPE
    touches only the last ``rope`` of each head's query-key columns.

    One path for one card and a mesh, as ``gqa_apply``. On a model axis of
    m ranks (rank r) where m divides H, rank r runs heads ``[r H / m,
    (r + 1) H / m)``: its block of ``wq_b``'s columns, of ``wk_b``'s and
    ``wv_b``'s heads and of ``wo``'s rows. ``c_kv`` and ``k_rope`` come
    from ``wkv_a``, which ``model`` does not split, so every rank makes
    them whole; the prefill expands keys and values for the rank's heads
    only and K6 runs on them; the ranks' ``wo`` partials are summed
    (``reduce``). Where m does not divide H every rank runs every head on
    queries gathered from its block of ``wq_b``'s columns (where m divides
    them), and multiplies its block of ``wo``'s rows (where m divides
    them).

    The caches (``c_kv`` ``(B, S_max, kv_lora)``, ``k_rope`` ``(B, S_max,
    rope)``) split their sequence over ``model`` where m divides
    ``S_max``: the prompt's rows and each decode row go to the rank that
    holds their positions (``_write_prompt``, ``_write_decode``). The
    absorbed decode against a split sequence is a flash-decoding combine:
    every head's ``q_abs`` and rope query (gathered) scored against the
    rank's positions, the ranks' maximum of each row (all-reduce max),
    then ``[sum p c_kv, sum p]`` ``(B, 1, H, kv_lora + 1)`` summed in one
    all-reduce; the quotient's rank's heads go through its block of
    ``wv_b``. Against a whole cache each rank attends its own heads."""
    mc, H = cfg.mla, cfg.n_heads
    B, S, D = x.shape
    nope, rope, vd, kvl = (mc.qk_nope_dim, mc.qk_rope_dim, mc.v_dim,
                           mc.kv_lora_rank)
    scale = (nope + rope) ** -0.5
    m, r = shd.size("model"), shd.axis("model").index
    heads = shd.tp(H)           # wk_b and wv_b split: H / m heads a rank
    Hl = H // m if heads else H
    h0 = r * Hl if heads else 0
    q_split, o_split = shd.tp(H * (nope + rope)), shd.tp(H * vd)

    qa = rmsnorm(p.wq_a(x), p.q_norm)
    q = p.wq_b(shd.enter(qa) if q_split else qa)
    if q_split and not heads:
        q = shd.gather(q, -1)
    q = q.reshape(B, S, Hl, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = p.wkv_a(x)                             # (B, S, kv_lora + rope)
    c_kv = rmsnorm(kv_a[..., :kvl], p.kv_norm)
    k_rope = apply_rope(kv_a[..., None, kvl:], positions,
                        cfg.rope_theta)            # (B, S, 1, rope)
    rows = (c_kv, k_rope[:, :, 0])

    if decode:
        if cache is None or S != 1:
            raise ValueError("decode takes one token and a cache")
        (ckv, krc), (c0, Tl, split) = _write_decode(cache, rows, shd)
        # absorbed attention: score against the compressed cache directly
        q_abs = torch.einsum("bqhn,khn->bqhk", q_nope.float(),
                             p.wk_b.float())
        q_rope = q_rope.float()
        if split and heads:         # every head, against this rank's rows
            q_abs, q_rope = shd.gather(q_abs, 2), shd.gather(q_rope, 2)
        ckv32 = ckv.float()
        s = (torch.einsum("bqhk,btk->bhqt", q_abs, ckv32)
             + torch.einsum("bqhr,btr->bhqt", q_rope, krc.float()))
        s = s * scale
        valid = c0 + torch.arange(Tl, device=x.device) <= cache.length
        if split:
            s = torch.where(valid, s, NEG_INF)
            pr = torch.exp(s - shd.all_max(s.amax(-1, keepdim=True)))
            part = shd.reduce(torch.cat(
                [torch.einsum("bhqt,btk->bqhk", pr, ckv32),
                 pr.sum(-1).permute(0, 2, 1)[..., None]], -1))
            ctx = (part[..., :kvl] / part[..., kvl:])[:, :, h0:h0 + Hl]
        else:
            pr = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
            ctx = torch.einsum("bhqt,btk->bqhk", pr, ckv32)
        o = torch.einsum("bqhk,khv->bqhv", ctx, p.wv_b.float())
        o = o.reshape(B, 1, Hl * vd).to(x.dtype)
        new_cache = KVCache(ckv, krc, cache.length + 1)
    else:
        # prefill: expand per-head K/V (the standard MLA formulation), for
        # this rank's heads
        ckv_h, kr_h = ((shd.enter(c_kv), shd.enter(k_rope)) if heads
                       else (c_kv, k_rope))
        k_nope = torch.einsum("btk,khn->bthn", ckv_h, p.wk_b)
        v = torch.einsum("btk,khv->bthv", ckv_h, p.wv_b)
        k = torch.cat([k_nope, kr_h.expand(B, S, Hl, rope)], dim=-1)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        o = _flash_attend(qf, k, v, causal=cfg.causal, scale=scale,
                          chunk=KV_CHUNK).reshape(B, S, Hl * vd)
        new_cache = None if cache is None else _write_prompt(cache, rows,
                                                             shd)
    if heads:
        return shd.reduce(p.wo(o)), new_cache
    if o_split:         # every head here, wo's rows split
        n = H * vd // m
        return shd.reduce(p.wo(shd.enter(o, -1, r * n, n))), new_cache
    return p.wo(o), new_cache
