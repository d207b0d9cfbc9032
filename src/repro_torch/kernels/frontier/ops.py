"""The frontier-expansion sweep of the matching solver on K5.

Counterpart of ``repro/kernels/frontier/ops.py``. ``frontier_op`` is what
``core/matching/bfs.py::_expand`` calls under ``backend="pallas"``: K5 on
the card, its plain version on the CPU, with any leading batch axes (the
reference ``vmap``s the op once per axis).
"""
from __future__ import annotations

from repro_torch.kernels.frontier.kernel import frontier


def frontier_op(adj, root_row, match_row):
    """``(min_root, claim_row)`` per column (see ``kernel.frontier``);
    inputs are made contiguous first."""
    return frontier(adj.contiguous(), root_row.contiguous(),
                    match_row.contiguous())
