"""Wrapper of K5 ``frontier``: one frontier-expansion sweep of matching.

The CUDA kernel is in ``kernels/csrc/frontier.cu`` (source note there: the
TPU kernel it replaces, what bounds it, what the design does about it).
On CUDA tensors the wrapper launches it once on the current stream, with
the clusters, threads and shared memory that ``launch_geometry`` picks
(the C entry launches with exactly these and refuses any that do not
fit), and adds one to ``launches``; on CPU tensors it runs the plain
version from ``ref.py``. There is no fallback: a CUDA tensor never
reaches the plain version, and a build or launch error raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.frontier.ref import frontier_ref

WARPS = 8                  # warps of a block that take labeled rows
CHUNK = 2 * 32 * WARPS     # rows a block stages at a time, two a thread
CLUSTER = 8                # blocks per cluster: the portable maximum
CLUSTER_MAX = 16           # with the non-portable cluster size allowed
SMS = 132                  # the H100's streaming multiprocessors
SMEM_MAX = 232448          # shared memory one block may use on sm_90
GRID_Y_MAX = 65535


class Geometry(NamedTuple):
    """How one call of K5 is launched (see ``launch_geometry``)."""
    vec: int               # columns per thread: 16 (a 16-byte load) or 1
    strip: int             # columns per cluster: 32 * vec
    cluster: int           # blocks per cluster, splitting the rows
    rows_per_block: int    # ceil(n_r / cluster), in chunks of CHUNK
    threads: int           # per block
    smem_bytes: int        # dynamic: the warps' keys (8 B a column)
    grid: tuple            # (cluster * strips, B)

    def c_args(self):
        """The seven ints the C entry launches with, once it has checked
        that they fit this build, the shapes and the card."""
        return (self.vec, self.cluster, self.rows_per_block, self.threads,
                self.smem_bytes, *self.grid)


def launch_geometry(B: int, n_r: int, n_c: int, aligned: bool,
                    cluster: int | None = None) -> Geometry:
    """K5's launch for ``B`` instances of ``n_r x n_c``.

    ``aligned``: ``n_c % 16 == 0`` and the adjacency 16-byte aligned, so a
    thread reads 16 columns of a row in one load (else 1). A cluster of
    blocks owns one instance and one strip of ``32 * vec`` columns; its
    blocks split the rows evenly. The cluster has ``CLUSTER`` blocks, or
    ``CLUSTER_MAX`` where clusters of ``CLUSTER`` would leave some of the
    card's ``SMS`` without a block; ``cluster`` (a power of two up to
    ``CLUSTER_MAX``)
    overrides the choice. Every block has ``WARPS`` warps, each with a
    plane of keys in shared memory."""
    vec = 16 if aligned else 1
    strip = 32 * vec
    strips = math.ceil(n_c / strip)
    if cluster is None:
        cluster = CLUSTER if B * strips * CLUSTER >= SMS else CLUSTER_MAX
    return Geometry(vec, strip, cluster, math.ceil(n_r / cluster),
                    32 * WARPS, WARPS * strip * 8, (cluster * strips, B))


_P, _I = ctypes.c_void_p, ctypes.c_int
_PROTOS = {"frontier": [_P] * 5 + [_I] * 10 + [_P],
           "frontier_max_active_clusters": [_I] * 5 + [_P]}


def max_active_clusters(g: Geometry) -> int:
    """How many clusters of ``g`` the card holds at once (CUDA's
    occupancy query); fewer than the grid's ``g.grid[0] * g.grid[1] /
    g.cluster`` means more than one wave."""
    lib = _build.load("frontier", _PROTOS)
    out = ctypes.c_int(0)
    _build.check(lib, lib.frontier_max_active_clusters(
        g.vec, g.cluster, g.smem_bytes, *g.grid, ctypes.byref(out)),
        "frontier_max_active_clusters")
    return out.value


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
    return _frontier(adj, root_row, match_row, None)


def _frontier(adj, root_row, match_row, geometry: Geometry | None):
    """``frontier``, launched with ``geometry`` instead of
    ``launch_geometry``'s choice when it is given; the card tests launch
    other cluster sizes this way. The result does not depend on the
    geometry."""
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
    g = geometry or launch_geometry(
        B, n_r, n_c, n_c % 16 == 0 and adj.data_ptr() % 16 == 0)
    min_root, claim = (torch.empty(tuple(batch) + (n_c,), dtype=torch.int32,
                                   device=adj.device) for _ in range(2))
    lib = _build.load("frontier", _PROTOS)
    stream = torch.cuda.current_stream(adj.device).cuda_stream
    _build.check(lib, lib.frontier(
        adj.data_ptr(), root_row.data_ptr(), match_row.data_ptr(),
        min_root.data_ptr(), claim.data_ptr(), B, n_r, n_c, *g.c_args(),
        stream), "frontier")
    frontier.launches += 1
    return min_root, claim


frontier.launches = 0
