"""Attention: GQA (+RoPE, qk-norm) and DeepSeek's MLA, prefill and decode.

Counterpart of ``repro/models/attention.py``. Prefill runs the causal,
GQA, online-softmax forward: on the card that is K6
(``kernels/flash_attention``, the kernel the JAX package wrote to replace
its ``_flash_fwd_scan``), on the CPU the plain chunked scan
``_flash_fwd_scan`` below. MLA's prefill expands the compressed keys and
values per head and goes through the same forward (qk width nope + rope,
v width ``v_dim``). Decode scores one query against the whole cache with
plain tensor ops, as in the JAX package; MLA's decode is the absorbed
form, scored against the compressed cache ``c_kv`` and the shared rope
keys directly, never expanding them.

The caches are updated in place (the JAX package's
``dynamic_update_slice`` makes a new buffer): prefill writes the prompt's
keys and values (MLA: ``c_kv`` and ``k_rope``) into the ``S_max``
buffers, decode writes one position at ``cache.length`` (clamped into the
buffer, as ``dynamic_update_slice`` clamps), and the returned ``KVCache``
shares their storage.

The int8 cache (``KVCacheQ``, ``cfg.kv_quant``) waits for ROADMAP M9;
``models.model.check_supported`` refuses it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.models.layers import (apply_rope, dense_std,
                                       depth_scaled_std, linear, normal_,
                                       rmsnorm)

NEG_INF = -1e30
KV_CHUNK = 512          # the plain scan's key chunk (the JAX kv_chunk)


class KVCache(NamedTuple):
    k: torch.Tensor     # GQA: (B, S_max, KV, dh) | MLA: c_kv (B, S_max, kv_lora)
    v: torch.Tensor     # GQA: (B, S_max, KV, dh) | MLA: k_rope (B, S_max, rope)
    length: torch.Tensor    # filled prefix length (0-d int32)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

class GQA(nn.Module):
    """The GQA mixer's parameters: ``wq``, ``wk``, ``wv``, ``wo`` (bias-free
    ``nn.Linear``, weights the JAX matrices transposed) and, with
    ``cfg.qk_norm``, the RMSNorm gains ``q_g`` and ``k_g``."""

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

    def forward(self, x, *, positions, cache=None, decode: bool):
        return gqa_apply(self, x, self.cfg, positions=positions, cache=cache,
                         decode=decode)


def init_gqa(p: GQA, generator: torch.Generator) -> GQA:
    """Draw ``p``'s weights from ``generator`` with the JAX ``init_gqa``'s
    stds: ``fan_in ** -0.5``, ``wo`` depth-scaled (gains stay 1)."""
    cfg = p.cfg
    for w in (p.wq, p.wk, p.wv):
        normal_(w.weight, dense_std(cfg.d_model), generator)
    normal_(p.wo.weight, depth_scaled_std(cfg.n_heads * cfg.dh, cfg.n_layers),
            generator)
    return p


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
    for idx in range(Sk // chunk):
        sl = slice(idx * chunk, (idx + 1) * chunk)
        kb = k[:, sl].repeat_interleave(G, 2).to(cdt).float()
        vb = v[:, sl].repeat_interleave(G, 2).to(cdt).float()
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kb) * scale
        if causal:
            pos_k = idx * chunk + torch.arange(chunk, device=dev)
            pen = torch.where(pos_q[:, None] >= pos_k[None, :], 0.0, NEG_INF)
            s = s + pen[None, None]
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(cdt).float(), vb)
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return acc / l[..., None], m + torch.log(l)


def _flash_attend(q, k, v, *, causal: bool, scale: float, chunk: int):
    """Prefill attention. q: (B,Sq,H,dh); k/v: (B,Sk,KV,·) -> (B,Sq,H,dv).

    K6 on a CUDA tensor, the plain scan on a CPU one. ``chunk`` is the
    scan's key chunk; the JAX package requires ``Sk % min(chunk, Sk) ==
    0`` and so does the port, on both paths, so the same prompts fail in
    both.
    """
    Sk = k.shape[1]
    chunk = min(chunk, Sk)
    if Sk % chunk:
        raise ValueError(f"key length {Sk} is not a multiple of the "
                         f"attention chunk {chunk}")
    if _build.on_card(q):
        return flash_attention_op(q, k, v, causal=causal, scale=scale)
    out, _ = _flash_fwd_scan(q, k, v, causal, scale, chunk)
    return out.transpose(1, 2).to(q.dtype)


def gqa_apply(p: GQA, x, cfg, *, positions, cache: Optional[KVCache] = None,
              decode: bool):
    """Returns (out, new_cache). Prefill: decode=False (cache optional)."""
    B, S, D = x.shape
    dh, H, KV = cfg.dh, cfg.n_heads, cfg.n_kv_heads
    q = p.wq(x).reshape(B, S, H, dh)
    k = p.wk(x).reshape(B, S, KV, dh)
    v = p.wv(x).reshape(B, S, KV, dh)
    if cfg.qk_norm:
        q, k = rmsnorm(q, p.q_g), rmsnorm(k, p.k_g)
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    scale = dh ** -0.5
    if decode:
        if cache is None or S != 1:
            raise ValueError("decode takes one token and a cache")
        T = cache.k.shape[1]
        # dynamic_update_slice clamps the start into the buffer; so does this
        at = cache.length.clamp(max=T - 1).long().reshape(1)
        kc = cache.k.index_copy_(1, at, k.to(cache.k.dtype))
        vc = cache.v.index_copy_(1, at, v.to(cache.v.dtype))
        new_cache = KVCache(kc, vc, cache.length + 1)
        G = H // KV
        # grouped decode score: q reshaped to (B, 1, KV, G, dh)
        qg = q.float().reshape(B, 1, KV, G, dh)
        s = torch.einsum("bqkgd,btkd->bkgqt", qg, kc.float()) * scale
        valid = torch.arange(T, device=x.device) <= cache.length
        s = torch.where(valid, s, NEG_INF)    # includes the new token
        pr = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqt,btkd->bqkgd", pr, vc.float())
        o = o.reshape(B, 1, H * dh).to(x.dtype)
    else:
        o = _flash_attend(q, k, v, causal=cfg.causal, scale=scale,
                          chunk=KV_CHUNK).reshape(B, S, H * dh)
        if cache is None:
            new_cache = None
        else:                   # prefill: write into the S_max buffer
            cache.k[:, :S] = k.to(cache.k.dtype)
            cache.v[:, :S] = v.to(cache.v.dtype)
            new_cache = KVCache(cache.k, cache.v, torch.tensor(
                S, dtype=torch.int32, device=x.device))
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

    def forward(self, x, *, positions, cache=None, decode: bool):
        return mla_apply(self, x, self.cfg, positions=positions, cache=cache,
                         decode=decode)


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


def mla_apply(p: MLA, x, cfg, *, positions, cache: Optional[KVCache] = None,
              decode: bool):
    """Returns (out, new_cache). Prefill: decode=False (cache optional).

    The JAX ``mla_apply``'s operation order. The scale is that of the
    query-key width, ``(nope + rope) ** -0.5``, not ``cfg.dh``'s."""
    m, H = cfg.mla, cfg.n_heads
    B, S, D = x.shape
    nope, rope, vd, kvl = (m.qk_nope_dim, m.qk_rope_dim, m.v_dim,
                           m.kv_lora_rank)
    scale = (nope + rope) ** -0.5

    q = p.wq_b(rmsnorm(p.wq_a(x), p.q_norm)).reshape(B, S, H, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = p.wkv_a(x)                             # (B, S, kv_lora + rope)
    c_kv = rmsnorm(kv_a[..., :kvl], p.kv_norm)
    k_rope = apply_rope(kv_a[..., None, kvl:], positions,
                        cfg.rope_theta)            # (B, S, 1, rope)

    if decode:
        if cache is None or S != 1:
            raise ValueError("decode takes one token and a cache")
        T = cache.k.shape[1]
        # dynamic_update_slice clamps the start into the buffer; so does this
        at = cache.length.clamp(max=T - 1).long().reshape(1)
        ckv = cache.k.index_copy_(1, at, c_kv.to(cache.k.dtype))
        krc = cache.v.index_copy_(1, at, k_rope[:, :, 0].to(cache.v.dtype))
        # absorbed attention: score against the compressed cache directly
        q_abs = torch.einsum("bqhn,khn->bqhk", q_nope.float(),
                             p.wk_b.float())
        ckv32 = ckv.float()
        s = (torch.einsum("bqhk,btk->bhqt", q_abs, ckv32)
             + torch.einsum("bqhr,btr->bhqt", q_rope.float(), krc.float()))
        s = s * scale
        valid = torch.arange(T, device=x.device) <= cache.length
        pr = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
        ctx = torch.einsum("bhqt,btk->bqhk", pr, ckv32)
        o = torch.einsum("bqhk,khv->bqhv", ctx, p.wv_b.float())
        o = o.reshape(B, 1, H * vd).to(x.dtype)
        new_cache = KVCache(ckv, krc, cache.length + 1)
    else:
        # prefill: expand per-head K/V (the standard MLA formulation)
        k_nope = torch.einsum("btk,khn->bthn", c_kv, p.wk_b)
        v = torch.einsum("btk,khv->bthv", c_kv, p.wv_b)
        k = torch.cat([k_nope, k_rope.expand(B, S, H, rope)], dim=-1)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        o = _flash_attend(qf, k, v, causal=cfg.causal, scale=scale,
                          chunk=KV_CHUNK).reshape(B, S, H * vd)
        if cache is None:
            new_cache = None
        else:                   # prefill: write into the S_max buffer
            cache.k[:, :S] = c_kv.to(cache.k.dtype)
            cache.v[:, :S] = k_rope[:, :, 0].to(cache.v.dtype)
            new_cache = KVCache(cache.k, cache.v, torch.tensor(
                S, dtype=torch.int32, device=x.device))
    return p.wo(o), new_cache
