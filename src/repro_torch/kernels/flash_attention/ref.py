"""Plain PyTorch version of K6 ``flash_attention_fwd`` (dense softmax).

Counterpart of ``repro/kernels/flash_attention/ref.py``. The CPU path of
the wrapper in ``kernel.py`` runs it, and ``chip_smoke.py`` holds the CUDA
kernel to it on the card (max abs error 3e-5 in float32, 2e-2 in
bfloat16, the bounds of the JAX package's kernel test).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, scale=None):
    """Attention in float32: q ``(B, Sq, H, dh)``, k ``(B, Sk, KV, dh)``, v
    ``(B, Sk, KV, dv)``; head h reads kv head ``h // (H // KV)``; causal
    masking is top-left aligned (``pos_q >= pos_k``). Returns
    ``(B, Sq, H, dv)`` in q's dtype."""
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
    return torch.einsum("bhqk,bkhd->bqhd", p, vv).to(q.dtype)
