"""Bytes and operations of a whole solve, from its shape and counters.

The least work of one instance, whatever kernels do it: the inputs read
once, each round's state read and written once, each heuristic pass's
state read once and its result written once, the answer written once.
The round and heuristic counts are the ones the comparison with the plain
reference holds the program to, so the count does not depend on how the
program implements a round.
"""
from __future__ import annotations

# max-flow on a grid, per node: the state is the excess and height (4 B
# each), four residual capacities and two terminal ones (float32)
GRID_STATE_B = 4 + 4 + 16 + 4 + 4
GRID_INPUT_B = 16 + 4 + 4
GRID_ROUND_OPS = 50          # the decision (about 30) and the deposit
GRID_BFS_B = 16 + 4 + 4 + 4  # capacities, sink capacity, height in; out
GRID_BFS_OPS = 18


def grid_instance(H: int, W: int, rounds: int,
                  heuristics: int) -> tuple[float, float]:
    """One grid instance: its inputs read and its cut written once,
    ``rounds`` rounds over the state, and ``heuristics + 2`` global
    relabels (the initial one and the one that finds the cut included),
    each a single pass."""
    nodes = H * W
    relabels = heuristics + 2
    nbytes = nodes * (GRID_INPUT_B + 1 + 2 * GRID_STATE_B * rounds
                      + GRID_BFS_B * relabels)
    nops = nodes * (GRID_ROUND_OPS * rounds + GRID_BFS_OPS * relabels)
    return float(nbytes), float(nops)


def assignment_instance(n: int, rounds: int,
                        rounds_per_heuristic: int) -> tuple[float, float]:
    """One ``(n, n)`` assignment instance: its int32 weights read once,
    each bidding round reading the int32 costs once and reading and
    writing the per-row and per-column state (prices, matching: 24 B a
    row), one price update per ``rounds_per_heuristic`` rounds reading
    the costs once, the matching written once; about 4 operations an
    entry a round."""
    entries = n * n
    updates = -(-rounds // rounds_per_heuristic)
    nbytes = (4 * entries + rounds * (4 * entries + 24 * n)
              + updates * 4 * entries + 4 * n)
    nops = 4 * entries * rounds + 4 * entries * updates
    return float(nbytes), float(nops)
