"""Wrapper of K3 ``bfs_relabel_sweeps``: joint min-plus BFS sweeps.

The CUDA kernel is in ``kernels/csrc/bfs_relabel.cu`` (source note there:
the TPU kernel it replaces, what bounds it, what the design does about
it). On CUDA tensors the wrapper runs the sweeps in ``ceil(sweeps /
R_MAX)`` kernel launches on the current stream, each with the tiles,
threads and shared memory that ``launch_geometry`` picks (the C entry
launches with exactly these and refuses any it cannot run), and adds them
to ``launches``; on CPU tensors it runs the plain version from ``ref.py``.
Both paths add the sweeps to ``sweeps``. There is no fallback: a CUDA
tensor never reaches the plain version, and a build or launch error
raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bfs_relabel.ref import bfs_relabel_sweeps_ref

# Relaxation sweeps per call of the fixpoint drivers (the reference's
# SWEEPS): one host sync per SWEEPS sweeps.
SWEEPS = 8
# Sweeps one launch runs in shared memory, and the halo each tile's window
# carries for them (``kHalo`` in the CUDA source).
R_MAX = 8
SMEM_MAX = 232448          # shared memory one block may use on sm_90
MAX_THREADS = 1024         # the kernel's launch bound (64 registers each)
N_SM = 132                 # streaming multiprocessors of an H100 SXM
# Tile shapes (tile_h, tile_w) the kernel is launched with, largest first.
# Each thread owns 4 nodes of one window row, so a block has
# (tile_h + 2 R_MAX) * (tile_w + 2 R_MAX) / 4 threads, a whole number of
# warps for each of them.
TILES = ((32, 64), (32, 32), (16, 32), (16, 16))


class Geometry(NamedTuple):
    """How one call of K3 is launched (see ``launch_geometry``)."""
    tile_h: int
    tile_w: int
    halo: int              # sweeps a launch may run: R_MAX
    threads: int           # per block
    smem_bytes: int        # dynamic shared memory: two int32 buffers a plane
    blocks: int            # per launch: B x tiles
    launches: int          # ceil(sweeps / R_MAX)


def geometry(B: int, H: int, W: int, sweeps: int, with_ds: bool,
             tile_h: int, tile_w: int) -> Geometry:
    """The launch of one call over ``tile_h x tile_w`` tiles."""
    wh, ww = tile_h + 2 * R_MAX, tile_w + 2 * R_MAX
    return Geometry(
        tile_h, tile_w, R_MAX, threads=wh * ww // 4,
        smem_bytes=(16 if with_ds else 8) * wh * ww,
        blocks=B * math.ceil(H / tile_h) * math.ceil(W / tile_w),
        launches=math.ceil(sweeps / R_MAX))


def launch_geometry(B: int, H: int, W: int, sweeps: int, with_ds: bool,
                    n_sm: int = N_SM) -> Geometry:
    """The tile shape of ``TILES`` that gives the busiest SM the fewest
    window nodes per sweep: ``ceil(blocks / n_sm)`` windows of
    ``(tile_h + 2 R_MAX) x (tile_w + 2 R_MAX)``. Large batches take large
    tiles (less halo); small grids take small ones, so the blocks still
    cover the SMs. Ties go to the larger tile."""
    def cost(g: Geometry) -> int:
        return (math.ceil(g.blocks / n_sm)
                * (g.tile_h + 2 * g.halo) * (g.tile_w + 2 * g.halo))
    options = [geometry(B, H, W, sweeps, with_ds, *t) for t in TILES]
    return min(options, key=cost)


_P, _I = ctypes.c_void_p, ctypes.c_int
_PROTOS = {"bfs_relabel_sweeps": [_P] * 10 + [_I] * 9 + [_P]}


def bfs_relabel_sweeps(cap, seed_t, seed_s, dt, ds, *, sweeps: int = SWEEPS):
    """``sweeps`` joint relaxation sweeps of both wavefront planes (K3).

    Args:
      cap: ``(4, B, H, W)`` float32 residual neighbour capacities.
      seed_t / seed_s: ``(B, H, W)`` int32 seed planes (1 where residual
        x→t resp. N+1 where residual x→s; INF elsewhere).
      dt / ds: ``(B, H, W)`` int32 current wavefront planes. Pass
        ``seed_s = ds = None`` to relax ``dt`` alone (the sink-only BFS).
        The kernel equals the plain version bit for bit when every seed
        and plane value is a height in [1, INF], as every seed and every
        plane the fixpoint drivers make is (source note in the ``.cu``).
      sweeps: how many sweeps, at least 1.

    Returns ``(dt, ds, changed)``: the relaxed planes (``ds`` None when it
    was off) and a 0-dim int32 on the device, 1 iff any value moved.
    """
    return _sweeps(cap, seed_t, seed_s, dt, ds, sweeps, None)


def _sweeps(cap, seed_t, seed_s, dt, ds, sweeps: int,
            tiles: tuple[int, int] | None):
    """``bfs_relabel_sweeps``, launched on ``tiles`` (a shape of ``TILES``)
    instead of ``launch_geometry``'s choice when they are given; the card
    tests and the smoke time every shape this way. The result does not
    depend on the tiles."""
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    if (seed_s is None) != (ds is None):
        raise ValueError("seed_s and ds must both be given or both be None")
    planes = [("seed_t", seed_t), ("dt", dt)]
    if ds is not None:
        planes += [("seed_s", seed_s), ("ds", ds)]
    if dt.dim() != 3:
        raise ValueError(f"dt must be (B, H, W), got {tuple(dt.shape)}")
    for name, t in planes:
        if t.dtype != torch.int32 or t.shape != dt.shape:
            raise ValueError(f"{name} must be int32 {tuple(dt.shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if cap.dtype != torch.float32 or cap.shape != (4,) + dt.shape:
        raise ValueError(f"cap must be float32 (4,) + {tuple(dt.shape)}")
    for name, t in planes + [("cap", cap)]:
        if t.device != dt.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dt.device}")

    bfs_relabel_sweeps.sweeps += sweeps
    if not _build.on_card(dt):
        return bfs_relabel_sweeps_ref(cap, seed_t, seed_s, dt, ds,
                                      sweeps=sweeps)
    B, H, W = dt.shape
    with_ds = ds is not None
    if tiles is None:
        g = launch_geometry(B, H, W, sweeps, with_ds,
                            torch.cuda.get_device_properties(
                                dt.device).multi_processor_count)
    else:
        g = geometry(B, H, W, sweeps, with_ds, *tiles)
    dt_a = torch.empty_like(dt)
    dt_b = torch.empty_like(dt) if g.launches > 1 else None
    ds_a = torch.empty_like(ds) if with_ds else None
    ds_b = torch.empty_like(ds) if with_ds and g.launches > 1 else None
    changed = torch.empty((), dtype=torch.int32, device=dt.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.load("bfs_relabel", _PROTOS)
    stream = torch.cuda.current_stream(dt.device).cuda_stream
    _build.check(lib, lib.bfs_relabel_sweeps(
        cap.data_ptr(), seed_t.data_ptr(), ptr(seed_s), dt.data_ptr(),
        ptr(ds), dt_a.data_ptr(), ptr(ds_a), ptr(dt_b), ptr(ds_b),
        changed.data_ptr(), B, H, W, sweeps, int(with_ds), g.tile_h,
        g.tile_w, g.threads, g.smem_bytes, stream), "bfs_relabel_sweeps")
    bfs_relabel_sweeps.launches += g.launches if g.blocks else 0
    if g.launches % 2:   # launch l writes buffer a when l is even
        return dt_a, ds_a, changed
    return dt_b, ds_b, changed


bfs_relabel_sweeps.launches = 0
bfs_relabel_sweeps.sweeps = 0
