"""Wrapper of K4 ``bidding``: per-row top-2 of masked part-reduced costs.

The CUDA kernel is in ``kernels/csrc/bidding.cu`` (source note there: the
TPU kernel it replaces, what bounds it, what the design does about it).
On CUDA tensors the wrapper launches it once on the current stream, with
the path and blocks that ``launch_geometry`` picks (the C entry launches
with exactly these and refuses any that do not fit), and adds one to
``launches``; on CPU tensors it runs the plain version from ``ref.py``.
There is no fallback: a CUDA tensor never reaches the plain version, and
a build or launch error raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bidding.ref import bidding_ref

WARPS = 8                  # rows per block, one warp each
THREADS = 32 * WARPS
VEC_COLS = 4               # columns a lane reads per load on the vector path


class Geometry(NamedTuple):
    """How one call of K4 is launched (see ``launch_geometry``)."""
    vec: int               # 1: 16-byte loads of 4 columns a lane; 0: scalar
    rows_per_block: int    # one row per warp
    blocks: int            # a 1-D grid over the flattened B * n_r rows
    threads: int           # per block

    def c_args(self):
        """The four ints the C entry launches with, once it has checked
        that they fit this build and the shapes."""
        return (self.vec, self.rows_per_block, self.blocks, self.threads)


def launch_geometry(B: int, n_r: int, n_c: int, aligned: bool) -> Geometry:
    """K4's launch for ``B`` instances of ``n_r x n_c``.

    ``aligned``: the costs and prices start on a 16-byte boundary and the
    mask on a 4-byte one. The rows of the batch, flattened, go 8 to a
    block, one per warp; a block may hold rows of two or more instances.
    The vector path (``aligned`` and ``n_c % 4 == 0``, so that a lane
    reads 4 columns of every row with one load of each input) is taken
    wherever it holds; else the scalar path, one column per load."""
    rows = B * n_r
    if rows < 1 or n_c < 1:
        raise ValueError(f"no rows to launch for ({B}, {n_r}, {n_c})")
    return Geometry(int(aligned and n_c % VEC_COLS == 0), WARPS,
                    math.ceil(rows / WARPS), THREADS)


def aligned_for_vectors(c, p_y, mask) -> bool:
    """``launch_geometry``'s ``aligned`` for these tensors."""
    return (c.data_ptr() % 16 == 0 and p_y.data_ptr() % 16 == 0
            and mask.data_ptr() % 4 == 0)


_P, _I = ctypes.c_void_p, ctypes.c_int
_PROTOS = {"bidding": [_P] * 6 + [_I] * 7 + [_P]}


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
    return _bidding(c, p_y, mask, None)


def _bidding(c, p_y, mask, geometry: Geometry | None):
    """``bidding``, launched with ``geometry`` instead of
    ``launch_geometry``'s choice when it is given; the card tests force
    the scalar path this way. The result does not depend on the
    geometry."""
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
    if B * n_r == 0:
        return min1, arg1, min2
    g = geometry or launch_geometry(B, n_r, n_c,
                                    aligned_for_vectors(c, p_y, mask))
    lib = _build.load("bidding", _PROTOS)
    stream = torch.cuda.current_stream(c.device).cuda_stream
    _build.check(lib, lib.bidding(
        c.data_ptr(), p_y.data_ptr(), mask.data_ptr(), min1.data_ptr(),
        arg1.data_ptr(), min2.data_ptr(), B, n_r, n_c, *g.c_args(), stream),
        "bidding")
    bidding.launches += 1
    return min1, arg1, min2


bidding.launches = 0
