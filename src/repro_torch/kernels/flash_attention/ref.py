"""Plain PyTorch version of K6 ``flash_attention_fwd`` (dense softmax).

Counterpart of ``repro/kernels/flash_attention/ref.py``. The CPU path of
the wrapper in ``kernel.py`` runs it, and ``chip_smoke.py`` holds the CUDA
kernel to it on the card (max abs error 3e-5 in float32, 2e-2 in
bfloat16, the bounds of the JAX package's kernel test).

``tf32_round`` and ``attention_tf32`` model the kernel's float32 arithmetic
(TF32 tensor-core products, one or three per product) for the tests; no
path of the port runs them.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, scale=None,
                        return_lse=False):
    """Attention in float32: q ``(B, Sq, H, dh)``, k ``(B, Sk, KV, dh)``, v
    ``(B, Sk, KV, dv)``; head h reads kv head ``h // (H // KV)``; causal
    masking is top-left aligned (``pos_q >= pos_k``). Returns
    ``(B, Sq, H, dv)`` in q's dtype; with ``return_lse`` also each row's
    float32 log-sum-exp of its scaled, masked scores, ``(B, H, Sq)``."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = dh ** -0.5 if scale is None else scale
    kk = k.repeat_interleave(G, 2).float()
    vv = v.repeat_interleave(G, 2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * scale
    if causal:
        m = (torch.arange(Sq, device=q.device)[:, None]
             >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(m[None, None], s, NEG_INF)
    p = torch.softmax(s, -1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vv).to(q.dtype)
    return (out, torch.logsumexp(s, -1)) if return_lse else out


def tf32_round(x):
    """float32 to the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32``: the low 13 bits of the pattern cleared
    after adding half of them. Zeros, infinities and NaN stay as they are;
    a finite value past TF32's largest rounds to infinity."""
    x = x.float().contiguous()
    bits = (x.view(torch.int32) + 0x1000) & -0x2000
    return torch.where(torch.isnan(x), x, bits.view(torch.float32))


def tf32_split(x):
    """``(hi, lo)`` with ``hi = tf32_round(x)``, ``lo = tf32_round(x - hi)``."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def _tf32_product(eq, a, b, products):
    """``einsum(eq, a, b)`` from TF32 parts, summed in float32: three
    products (lo*hi + hi*lo + hi*hi, as the kernel does in float32) or one
    (hi*hi)."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    if products == 1:
        return torch.einsum(eq, ah, bh)
    if products != 3:
        raise ValueError(f"products must be 1 or 3, got {products}")
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def attention_tf32(q, k, v, *, causal=True, scale=None, products=3):
    """``flash_attention_ref`` in float32 with both products on TF32 parts
    (``_tf32_product``): the error model of the kernel's float32 path,
    whose tensor cores multiply TF32 values exactly and sum in float32."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = dh ** -0.5 if scale is None else scale
    kk = k.repeat_interleave(G, 2).float()
    vv = v.repeat_interleave(G, 2).float()
    s = _tf32_product("bqhd,bkhd->bhqk", q.float(), kk, products) * scale
    if causal:
        m = (torch.arange(Sq, device=q.device)[:, None]
             >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(m[None, None], s, NEG_INF)
    p = torch.softmax(s, -1)
    return _tf32_product("bhqk,bkhd->bqhd", p, vv, products)
