"""Carry problems and states between the JAX package and the port.

The port's counterpart of carrying weights across. The JAX package's
named tuples and the port's share names, field names and leaf layouts
(grid max-flow: ``GridProblem``, ``GridFlowState``, ``GridFlowResult``;
assignment: ``AssignmentResult``, ``_RefineState``, ``_ScaleState``;
matching: ``MatchingResult``, ``MatchState``), so a structure, nested
ones included, crosses leaf by leaf:

* ``to_torch`` takes a (named) tuple whose leaves are numpy arrays or
  anything ``np.asarray`` reads (a JAX array, say) and builds the port's
  structure of the same name on a device, every leaf with the same shape
  and dtype, so an internal-layout state stays internal (``cap``
  ``(4, ..., H, W)``) and a public one public (``cap`` ``(B, 4, H, W)``);
* ``to_numpy`` turns any such structure, the port's or the JAX
  package's, into a dict of numpy arrays under the field names.

Imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.assignment import cost_scaling
from repro_torch.core.matching import bfs
from repro_torch.core.maxflow import grid

_TYPES = {t.__name__: t for t in (
    grid.GridProblem, grid.GridFlowState, grid.GridFlowResult,
    cost_scaling.AssignmentResult, cost_scaling._RefineState,
    cost_scaling._ScaleState, bfs.MatchingResult, bfs.MatchState)}


def _leaf_to_torch(x, device: torch.device) -> torch.Tensor:
    return torch.tensor(np.array(x, copy=True), device=device)


def to_torch(tree, device=None):
    """The port's counterpart of ``tree`` on ``device`` (default cuda).

    Named tuples map to the port's class of the same name (see the module
    note), nested ones too; ``None`` leaves stay ``None``.
    """
    dev = resolve_device(device)
    if tree is None:
        return None
    if isinstance(tree, tuple):
        leaves = [to_torch(x, dev) for x in tree]
        name = type(tree).__name__
        if hasattr(tree, "_fields"):
            if name not in _TYPES:
                raise TypeError(f"no port counterpart for {name}")
            return _TYPES[name](*leaves)
        return tuple(leaves)
    return _leaf_to_torch(tree, dev)


def _leaf_to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_numpy(tree):
    """A dict of numpy arrays under the field names (nested for nested
    named tuples, ``None`` kept), for a structure of either package."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return {k: to_numpy(v) for k, v in zip(tree._fields, tree)}
    return _leaf_to_numpy(tree)
