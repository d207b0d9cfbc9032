"""Wrapper of K4 ``bidding``: per-row top-2 of masked part-reduced costs.

The CUDA kernel is in ``kernels/csrc/bidding.cu`` (source note there: the
TPU kernel it replaces, what bounds it, what the design does about it).
On CUDA tensors the wrapper launches it on the current stream and adds one
to ``launches``; on CPU tensors it runs the plain version from ``ref.py``.
There is no fallback: a CUDA tensor never reaches the plain version, and a
build or launch error raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bidding.ref import bidding_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_PROTOS = {"bidding": [_P] * 6 + [_I] * 3 + [_P]}


def bidding(c, p_y, mask):
    """Row-wise ``(min1, arg1, min2)`` of ``where(mask, INF, c - p_y)``.

    Args:
      c: ``(..., n_r, n_c)`` int32 costs.
      p_y: ``(..., n_c)`` int32 column prices (same batch axes).
      mask: ``(..., n_r, n_c)`` bool, True where the arc is not residual.

    Returns three ``(..., n_r)`` int32 tensors, as ``ref.bidding_ref``:
    the minimum, its first column, and the minimum over the other columns
    (INF where there is none).
    """
    if c.dim() < 2 or c.shape[-1] < 1:
        raise ValueError(f"c must be (..., n_r, n_c) with n_c >= 1, got "
                         f"{tuple(c.shape)}")
    *batch, n_r, n_c = c.shape
    for name, t, dt, shape in (
            ("c", c, torch.int32, tuple(c.shape)),
            ("p_y", p_y, torch.int32, tuple(batch) + (n_c,)),
            ("mask", mask, torch.bool, tuple(c.shape))):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != c.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {c.device}")
    if not _build.on_card(c):
        return bidding_ref(c, p_y, mask)
    B = int(np.prod(batch, dtype=np.int64))
    min1, arg1, min2 = (torch.empty(tuple(batch) + (n_r,), dtype=torch.int32,
                                    device=c.device) for _ in range(3))
    lib = _build.load("bidding", _PROTOS)
    stream = torch.cuda.current_stream(c.device).cuda_stream
    _build.check(lib, lib.bidding(
        c.data_ptr(), p_y.data_ptr(), mask.data_ptr(), min1.data_ptr(),
        arg1.data_ptr(), min2.data_ptr(), B, n_r, n_c, stream), "bidding")
    bidding.launches += 1
    return min1, arg1, min2


bidding.launches = 0
