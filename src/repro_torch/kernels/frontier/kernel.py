"""Wrapper of K5 ``frontier``: one frontier-expansion sweep of matching.

The CUDA kernel is in ``kernels/csrc/frontier.cu`` (source note there: the
TPU kernel it replaces, what bounds it, what the design does about it).
On CUDA tensors the wrapper launches it on the current stream (a partial
pass over row chunks and a small pass over the chunks' keys) and adds one
to ``launches``; on CPU tensors it runs the plain version from ``ref.py``.
There is no fallback: a CUDA tensor never reaches the plain version, and a
build or launch error raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.frontier.ref import frontier_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_PROTOS = {"frontier": [_P] * 6 + [_I] * 4 + [_P],
           "frontier_chunk_rows": []}


def frontier(adj, root_row, match_row):
    """Per-column ``(min_root, claim_row)`` over labeled candidate rows.

    Args:
      adj: ``(..., n_r, n_c)`` bool adjacency.
      root_row: ``(..., n_r)`` int32 root labels (INF = unlabeled).
      match_row: ``(..., n_r)`` int32 matched column per row (-1 = free).

    Returns two ``(..., n_c)`` int32 tensors, as ``ref.frontier_ref``:
    the smallest candidate root per column and the smallest row holding
    it, ``(INF, 0)`` for a column without a candidate.
    """
    if adj.dim() < 2 or adj.shape[-2] < 1:
        raise ValueError(f"adj must be (..., n_r, n_c) with n_r >= 1, got "
                         f"{tuple(adj.shape)}")
    *batch, n_r, n_c = adj.shape
    for name, t, dt, shape in (
            ("adj", adj, torch.bool, tuple(adj.shape)),
            ("root_row", root_row, torch.int32, tuple(batch) + (n_r,)),
            ("match_row", match_row, torch.int32, tuple(batch) + (n_r,))):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != adj.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {adj.device}")
    if not _build.on_card(adj):
        return frontier_ref(adj, root_row, match_row)
    B = int(np.prod(batch, dtype=np.int64))
    lib = _build.load("frontier", _PROTOS)
    chunk = lib.frontier_chunk_rows()
    n_chunks = -(-n_r // chunk)
    part = torch.empty((B, n_chunks, n_c), dtype=torch.int64,
                       device=adj.device)
    min_root, claim = (torch.empty(tuple(batch) + (n_c,), dtype=torch.int32,
                                   device=adj.device) for _ in range(2))
    stream = torch.cuda.current_stream(adj.device).cuda_stream
    _build.check(lib, lib.frontier(
        adj.data_ptr(), root_row.data_ptr(), match_row.data_ptr(),
        part.data_ptr(), min_root.data_ptr(), claim.data_ptr(), B, n_r, n_c,
        n_chunks, stream), "frontier")
    frontier.launches += 1
    return min_root, claim


frontier.launches = 0
