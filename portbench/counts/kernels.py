"""Bytes and operations of one launch of the solver kernels.

Each count is what a launch must move and compute at least: every input
byte read once and every output byte written once, whatever the kernel
reads again, and the integer or float work per element. Copied from the
port's smoke script (``bound``, ``k3_bound``, ``k4_bound``), where they
were worked out against each kernel's interface.
"""
from __future__ import annotations

K3_SWEEPS = 8   # sweeps of one call of the grid path's BFS


def k1(nodes: int) -> tuple[float, float]:
    """K1 ``grid_push_decide`` over ``nodes`` grid nodes: e, h, the four
    capacities, the two terminal capacities read (32 B), the new height
    and six pushes written (28 B); about 30 operations a node."""
    return 60.0 * nodes, 30.0 * nodes


def k3(nodes: int, sweeps: float = K3_SWEEPS,
       with_ds: bool = False) -> tuple[float, float]:
    """K3 ``bfs_relabel_sweeps``, one launch of ``sweeps`` sweeps over
    ``nodes`` nodes: capacities, seeds and planes read once, planes
    written once (28 B a node with the source plane off, 40 B with it);
    about 18 integer operations a node, sweep and plane."""
    planes = 2 if with_ds else 1
    return (12.0 * planes + 16.0) * nodes, 18.0 * planes * sweeps * nodes


def k4(batch: int, n: int) -> tuple[float, float]:
    """K4 ``bidding`` on ``batch`` ``(n, n)`` matrices: costs and mask
    read once (5 B an entry), the column prices read and three per-row
    outputs written (16 B a row); about 4 integer operations an entry."""
    entries = batch * n * n
    return 5.0 * entries + 16.0 * batch * n, 4.0 * entries
