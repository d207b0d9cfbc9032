"""Problem generators and the scipy max-flow oracle (numpy / scipy only).

The port's own copy of ``repro/core/maxflow/ref.py``: the generators draw
from a ``numpy.random.Generator`` in the same order, so one seed gives the
same instance in both packages. Every generator yields integer-valued
float32 capacities.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import maximum_flow

UP, DOWN, LEFT, RIGHT = 0, 1, 2, 3


def random_grid_problem(rng: np.random.Generator, H: int, W: int,
                        max_cap: int = 10, terminal_density: float = 0.5):
    """Random integer grid-cut instance (terminal arcs randomly sparse)."""
    cap = rng.integers(0, max_cap + 1, size=(4, H, W)).astype(np.float32)
    # zero out off-grid directions so instances are well-formed
    cap[UP, 0, :] = 0
    cap[DOWN, -1, :] = 0
    cap[LEFT, :, 0] = 0
    cap[RIGHT, :, -1] = 0
    cs = rng.integers(0, max_cap + 1, size=(H, W)).astype(np.float32)
    ct = rng.integers(0, max_cap + 1, size=(H, W)).astype(np.float32)
    cs *= rng.random((H, W)) < terminal_density
    ct *= rng.random((H, W)) < terminal_density
    return cap, cs, ct


def long_path_problem(H: int, W: int, path_len: int = 0):
    """Adversarial: serpentine corridors that strand excess all along them.

    Each corridor (one per 64-row band) is a boustrophedon path of
    ``path_len`` cells (default ``min(2·W, 128)``): the source feeds its
    head, only its tail reaches the sink, and the corridor edge out of
    cell k has capacity ``L-1-k``, so every interior cell strands one unit
    of excess that must travel back to the source (max-flow is 1 per
    corridor).
    """
    if path_len <= 0:
        path_len = min(2 * W, 128)
    n_paths = max(1, H // 64)
    band = H // n_paths
    cap_nbr = np.zeros((4, H, W), np.float32)
    cs = np.zeros((H, W), np.float32)
    ct = np.zeros((H, W), np.float32)

    wc = min(W, 64)             # corridor column span: switchback geometry
    for m in range(n_paths):    # must not straighten out on wide grids
        r0 = m * band
        cells = []
        for i in range(r0, min(r0 + band, H)):
            js = range(wc) if (i - r0) % 2 == 0 else range(wc - 1, -1, -1)
            cells.extend((i, j) for j in js)
        path = cells[:min(path_len, len(cells))]
        L = len(path)
        for k, ((i, j), (ii, jj)) in enumerate(zip(path, path[1:])):
            c = L - 1 - k
            if ii == i + 1:
                cap_nbr[DOWN, i, j] = c
                cap_nbr[UP, ii, jj] = c
            elif jj == j + 1:
                cap_nbr[RIGHT, i, j] = c
                cap_nbr[LEFT, ii, jj] = c
            else:
                cap_nbr[LEFT, i, j] = c
                cap_nbr[RIGHT, ii, jj] = c
        cs[path[0]] = L - 1 if L > 1 else 1
        ct[path[-1]] = 1        # the bottleneck: max-flow == 1 per corridor
    return cap_nbr, cs, ct


def checkerboard_problem(H: int, W: int, hi: int = 16, lo: int = 1):
    """Adversarial: alternating hi/lo capacity cells, a relabel stress.

    Source arcs on the left column, sink arcs on the right; neighbour
    capacities alternate ``hi``/``lo`` in a checkerboard, so excess
    oscillates on height plateaus until a relabel pass re-grades them.
    """
    i, j = np.mgrid[0:H, 0:W]
    board = np.where((i + j) % 2 == 0, float(hi), float(lo))
    cap_nbr = np.zeros((4, H, W), np.float32)
    for d in range(4):
        cap_nbr[d] = board
    cap_nbr[UP, 0, :] = 0
    cap_nbr[DOWN, -1, :] = 0
    cap_nbr[LEFT, :, 0] = 0
    cap_nbr[RIGHT, :, -1] = 0
    cs = np.zeros((H, W), np.float32)
    ct = np.zeros((H, W), np.float32)
    cs[:, 0] = hi
    ct[:, -1] = lo
    return cap_nbr, cs, ct


def random_wide_problem(rng: np.random.Generator, H: int, W: int,
                        max_cap: int = 64):
    """Adversarial: heavy-tailed capacities, terminals on opposite edges."""
    cap = np.exp(rng.uniform(0, np.log(max_cap + 1), size=(4, H, W)))
    cap = np.floor(cap).astype(np.float32)
    cap[UP, 0, :] = 0
    cap[DOWN, -1, :] = 0
    cap[LEFT, :, 0] = 0
    cap[RIGHT, :, -1] = 0
    cs = np.zeros((H, W), np.float32)
    ct = np.zeros((H, W), np.float32)
    cs[:, 0] = np.floor(
        np.exp(rng.uniform(0, np.log(max_cap + 1), size=H))).astype(np.float32)
    ct[:, -1] = np.floor(
        np.exp(rng.uniform(0, np.log(max_cap + 1), size=H))).astype(np.float32)
    return cap, cs, ct


ADVERSARIAL_GENERATORS = {
    "long_path": lambda rng, H, W: long_path_problem(H, W),
    "checkerboard": lambda rng, H, W: checkerboard_problem(H, W),
    "random_wide": random_wide_problem,
}


def maxflow_grid_ref(cap_nbr: np.ndarray, cap_src: np.ndarray,
                     cap_sink: np.ndarray) -> int:
    """Exact max-flow value via scipy's Dinic (integer capacities).

    Builds the same graph as the reference oracle (grid arcs with positive
    capacity toward in-grid neighbours, s -> x and x -> t arcs), with the
    edge lists assembled by numpy instead of a Python loop over nodes.
    """
    cap_nbr = np.asarray(cap_nbr)
    cap_src = np.asarray(cap_src)
    cap_sink = np.asarray(cap_sink)
    H, W = cap_src.shape
    n = H * W
    s, t = n, n + 1
    ii, jj = np.mgrid[0:H, 0:W]
    nid = ii * W + jj
    rows, cols, data = [], [], []
    for d, (di, dj) in enumerate([(-1, 0), (1, 0), (0, -1), (0, 1)]):
        ni, nj = ii + di, jj + dj
        c = cap_nbr[d].astype(np.int64)
        ok = (ni >= 0) & (ni < H) & (nj >= 0) & (nj < W) & (c > 0)
        rows.append(nid[ok])
        cols.append((ni * W + nj)[ok])
        data.append(c[ok])
    src = cap_src > 0
    rows.append(np.full(int(src.sum()), s))
    cols.append(nid[src])
    data.append(cap_src[src].astype(np.int64))
    snk = cap_sink > 0
    rows.append(nid[snk])
    cols.append(np.full(int(snk.sum()), t))
    data.append(cap_sink[snk].astype(np.int64))
    graph = sp.csr_matrix(
        (np.concatenate(data), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n + 2, n + 2), dtype=np.int64)
    return int(maximum_flow(graph, s, t).flow_value)
