"""Wrappers of K1 ``grid_push_decide`` and K2 ``grid_push_decide_sched``.

The CUDA kernels are in ``kernels/csrc/grid_push.cu`` (source note there:
the TPU kernels they replace, what bounds them, what the design does about
it). A wrapper checks its inputs, then on CUDA tensors launches its kernel
on the current stream and adds one to its ``launches`` count, and on CPU
tensors runs the plain version from ``ref.py``. There is no fallback: a
CUDA tensor never reaches the plain version, and a build or launch error
raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.grid_push.ref import (grid_push_decide_ref,
                                               grid_push_decide_sched_ref)

_P, _I = ctypes.c_void_p, ctypes.c_int
_PROTOS = {
    "grid_push_decide": [_P] * 7 + [_I] * 4 + [_P],
    "grid_push_decide_sched": [_P] * 9 + [_I] * 7 + [_P],
}


def _check_planes(e, h, cap, cap_src, cap_sink) -> None:
    for name, t, dt in (("e", e, torch.float32), ("h", h, torch.int32),
                        ("cap", cap, torch.float32),
                        ("cap_src", cap_src, torch.float32),
                        ("cap_sink", cap_sink, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != e.device:
            raise ValueError(f"{name} is on {t.device}, e on {e.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if e.dim() < 2:
        raise ValueError(f"e must be (..., H, W), got {tuple(e.shape)}")
    for name, t in (("h", h), ("cap_src", cap_src), ("cap_sink", cap_sink)):
        if t.shape != e.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != e {tuple(e.shape)}")
    if cap.shape != (4,) + e.shape:
        raise ValueError(f"cap {tuple(cap.shape)} != (4,) + {tuple(e.shape)}")


def grid_push_decide(e, h, cap, cap_src, cap_sink, n_nodes: int):
    """Per-node push/relabel decision for one Jacobi round (K1).

    ``e``/``h``/``cap_src``/``cap_sink`` ``(..., H, W)`` (float32, int32,
    float32, float32), ``cap`` ``(4, ..., H, W)`` float32, all contiguous
    on one device; ``n_nodes`` the paper's N = H*W + 2. Returns
    ``(h_new, delta)``: ``h_new`` like ``h``, ``delta`` ``(6, ..., H, W)``
    the flow pushed toward [sink, source, UP, DOWN, LEFT, RIGHT]. The
    neighbour heights are read from ``h`` (INF outside the grid).
    """
    _check_planes(e, h, cap, cap_src, cap_sink)
    if not _build.on_card(e):
        return grid_push_decide_ref(e, h, cap, cap_src, cap_sink, n_nodes)
    *batch, H, W = e.shape
    B = int(np.prod(batch, dtype=np.int64))
    h_new = torch.empty_like(h)
    delta = torch.empty((6,) + tuple(e.shape), dtype=torch.float32,
                        device=e.device)
    lib = _build.load("grid_push", _PROTOS)
    stream = torch.cuda.current_stream(e.device).cuda_stream
    _build.check(lib, lib.grid_push_decide(
        e.data_ptr(), h.data_ptr(), cap.data_ptr(), cap_src.data_ptr(),
        cap_sink.data_ptr(), h_new.data_ptr(), delta.data_ptr(),
        int(n_nodes), B, H, W, stream), "grid_push_decide")
    grid_push_decide.launches += 1
    return h_new, delta


grid_push_decide.launches = 0


def grid_push_decide_sched(e, h, cap, cap_src, cap_sink, sched, n_active,
                           n_nodes: int, *, block_h: int, block_w: int):
    """The K1 decision over a per-instance active-tile schedule (K2).

    ``e``/``h``/``cap_src``/``cap_sink`` ``(B, H, W)``, ``cap``
    ``(4, B, H, W)``; ``sched`` ``(B, T)`` int32, per instance a
    permutation of the row-major ids of the ``block_h x block_w`` tiles
    (``T = (H // block_h) * (W // block_w)``) with the active tiles first;
    ``n_active`` ``(B,)`` int32. Tiles at schedule positions below
    ``n_active[b]`` are decided, the others copied through (``h`` kept,
    ``delta`` 0). Same outputs as ``grid_push_decide``.
    """
    _check_planes(e, h, cap, cap_src, cap_sink)
    if e.dim() != 3:
        raise ValueError(f"e must be (B, H, W), got {tuple(e.shape)}")
    B, H, W = e.shape
    if H % block_h or W % block_w:
        raise ValueError(f"tile {block_h}x{block_w} must divide {H}x{W}")
    T = (H // block_h) * (W // block_w)
    for name, t, shape in (("sched", sched, (B, T)),
                           ("n_active", n_active, (B,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != e.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {e.device}")
    if not _build.on_card(e):
        return grid_push_decide_sched_ref(e, h, cap, cap_src, cap_sink,
                                          sched, n_active, n_nodes,
                                          block_h, block_w)
    h_new = torch.empty_like(h)
    delta = torch.empty((6, B, H, W), dtype=torch.float32, device=e.device)
    lib = _build.load("grid_push", _PROTOS)
    stream = torch.cuda.current_stream(e.device).cuda_stream
    _build.check(lib, lib.grid_push_decide_sched(
        e.data_ptr(), h.data_ptr(), cap.data_ptr(), cap_src.data_ptr(),
        cap_sink.data_ptr(), sched.data_ptr(), n_active.data_ptr(),
        h_new.data_ptr(), delta.data_ptr(), int(n_nodes), B, H, W, T,
        block_h, block_w, stream), "grid_push_decide_sched")
    grid_push_decide_sched.launches += 1
    return h_new, delta


grid_push_decide_sched.launches = 0
