"""Wrapper of K3 ``bfs_relabel_sweeps``: joint min-plus BFS sweeps.

The CUDA kernel is in ``kernels/csrc/bfs_relabel.cu`` (source note there:
the TPU kernel it replaces, what bounds it, what the design does about
it). On CUDA tensors the wrapper runs ``sweeps`` kernel launches on the
current stream and adds each to ``launches``; on CPU tensors it runs the
plain version from ``ref.py``. There is no fallback: a CUDA tensor never
reaches the plain version, and a build or launch error raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bfs_relabel.ref import bfs_relabel_sweeps_ref

# Relaxation sweeps per call of the balanced backend's fixpoint driver
# (the reference's SWEEPS): one host sync per SWEEPS sweeps.
SWEEPS = 8

_P, _I = ctypes.c_void_p, ctypes.c_int
_PROTOS = {"bfs_relabel_sweeps": [_P] * 10 + [_I] * 5 + [_P]}


def bfs_relabel_sweeps(cap, seed_t, seed_s, dt, ds, *, sweeps: int = SWEEPS):
    """``sweeps`` joint relaxation sweeps of both wavefront planes (K3).

    Args:
      cap: ``(4, B, H, W)`` float32 residual neighbour capacities.
      seed_t / seed_s: ``(B, H, W)`` int32 seed planes (1 where residual
        x→t resp. N+1 where residual x→s; INF elsewhere).
      dt / ds: ``(B, H, W)`` int32 current wavefront planes. Pass
        ``seed_s = ds = None`` to relax ``dt`` alone (the sink-only BFS).
      sweeps: how many sweeps, at least 1.

    Returns ``(dt, ds, changed)``: the relaxed planes (``ds`` None when it
    was off) and a 0-dim int32 on the device, 1 iff any value moved.
    """
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

    if not _build.on_card(dt):
        return bfs_relabel_sweeps_ref(cap, seed_t, seed_s, dt, ds,
                                      sweeps=sweeps)
    B, H, W = dt.shape
    dt_a, dt_b = torch.empty_like(dt), torch.empty_like(dt)
    ds_a = ds_b = None
    if ds is not None:
        ds_a, ds_b = torch.empty_like(ds), torch.empty_like(ds)
    changed = torch.empty((), dtype=torch.int32, device=dt.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.load("bfs_relabel", _PROTOS)
    stream = torch.cuda.current_stream(dt.device).cuda_stream
    _build.check(lib, lib.bfs_relabel_sweeps(
        cap.data_ptr(), seed_t.data_ptr(), ptr(seed_s), dt.data_ptr(),
        ptr(ds), dt_a.data_ptr(), ptr(ds_a), dt_b.data_ptr(), ptr(ds_b),
        changed.data_ptr(), B, H, W, sweeps, int(ds is not None), stream),
        "bfs_relabel_sweeps")
    bfs_relabel_sweeps.launches += sweeps
    if sweeps % 2:   # sweep k writes buffer a when k is even
        return dt_a, ds_a, changed
    return dt_b, ds_b, changed


bfs_relabel_sweeps.launches = 0
