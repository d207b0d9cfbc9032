"""Wrapper of K6 ``flash_attention_fwd``: causal GQA attention forward.

The CUDA kernel is in ``kernels/csrc/flash_attention.cu`` (source note
there: the TPU kernel it replaces, what bounds it, what the design does
about it). On CUDA tensors the wrapper launches it on the current stream
and adds one to ``launches``; on CPU tensors it runs the plain version
from ``ref.py``. There is no fallback: a CUDA tensor never reaches the
plain version, and a build or launch error raises. The kernel has no
backward yet, so it refuses inputs that autograd tracks.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_PROTOS = {"flash_attention_fwd": [_P] * 4 + [_I] * 8
           + [ctypes.c_float, _I, _P]}
_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        scale: float | None = None):
    """Attention forward: q ``(B, Sq, H, dh)``, k ``(B, Sk, KV, dh)``, v
    ``(B, Sk, KV, dv)``. Returns ``(B, Sq, H, dv)`` in q's dtype.

    Head h reads kv head ``h // (H // KV)`` (``KV = 1`` is MQA); causal
    masking is top-left aligned (``pos_q >= pos_k``, both from 0); ``scale``
    defaults to ``dh ** -0.5``. float32 or bfloat16, all three alike, with
    float32 accumulation; ``dh`` and ``dv`` up to 256 each; any ``Sq`` and
    ``Sk >= 1``.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, dim)")
    B, Sq, H, dh = q.shape
    Sk, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    if (tuple(k.shape) != (B, Sk, KV, dh)
            or tuple(v.shape) != (B, Sk, KV, dv)):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if KV < 1 or H % KV or Sk < 1:
        raise ValueError(f"need Sk >= 1 and H % KV == 0 (H={H}, KV={KV}, "
                         f"Sk={Sk})")
    if not (1 <= dh <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"dh={dh}, dv={dv}: each must be in 1..256")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one of {_DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    scale = dh ** -0.5 if scale is None else float(scale)
    if not _build.on_card(q):
        return flash_attention_ref(q, k, v, causal=causal, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "K6 has no backward kernel yet (ROADMAP M9: training with "
            "_flash_core_bwd); call it under torch.no_grad()")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((B, Sq, H, dv), dtype=q.dtype, device=q.device)
    lib = _build.load("flash_attention", _PROTOS)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(lib, lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
        H, KV, dh, dv, int(q.dtype == torch.bfloat16), scale, int(causal),
        stream), "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
