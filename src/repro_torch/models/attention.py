"""Attention: GQA (+RoPE, qk-norm), prefill and decode.

Counterpart of ``repro/models/attention.py``, its GQA half. Prefill runs
the causal, GQA, online-softmax forward: on the card that is K6
(``kernels/flash_attention``, the kernel the JAX package wrote to replace
its ``_flash_fwd_scan``), on the CPU the plain chunked scan
``_flash_fwd_scan`` below. Decode scores one query against the whole
cache with plain tensor ops, as in the JAX package.

The caches are updated in place (the JAX package's
``dynamic_update_slice`` makes a new buffer): prefill writes the prompt's
keys and values into the ``S_max`` buffers, decode writes one position at
``cache.length``, and the returned ``KVCache`` shares their storage.

DeepSeek's MLA (``init_mla``, ``mla_apply``) waits for ROADMAP M9 and
raises; so does the int8 cache (``KVCacheQ``, ``cfg.kv_quant``), which
``models.model.check_supported`` refuses.
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
NOT_PORTED = "not ported yet (ROADMAP M9: MLA attention)"


class KVCache(NamedTuple):
    k: torch.Tensor         # (B, S_max, KV, dh)
    v: torch.Tensor         # (B, S_max, KV, dh)
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
# MLA (DeepSeek-V2): waits for ROADMAP M9
# ---------------------------------------------------------------------------

def init_mla(*args, **kwargs):
    raise NotImplementedError(NOT_PORTED)


def mla_apply(*args, **kwargs):
    raise NotImplementedError(NOT_PORTED)
