"""PyTorch + CUDA port of ``repro`` for one NVIDIA Hopper card (H100).

The package mirrors ``src/repro/`` path for path: the counterpart of
``repro/core/maxflow/grid.py`` is ``repro_torch/core/maxflow/grid.py``,
of ``repro/kernels/grid_push/`` is ``repro_torch/kernels/grid_push/``.
Plain tensor code is PyTorch; every Pallas TPU kernel on a ported path is
a hand-written CUDA C++ kernel for ``sm_90a`` under ``kernels/csrc/``,
built with ``nvcc`` at first use and bound through ``ctypes``.

Entry points run on the card unless the caller passes ``device="cpu"``;
on the CPU each kernel wrapper runs its plain PyTorch version instead.
This package imports neither ``jax`` nor anything of ``repro``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises instead of falling back to the CPU when CUDA is asked for (the
    default) and no card is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device=\"cpu\" to run the plain PyTorch "
            "versions on the CPU")
    return dev
