"""Hopcroft–Karp oracle and instance generators of bipartite matching.

The port's own copy of ``repro/core/matching/ref.py`` (numpy only). The
generators draw from a ``numpy.random.Generator`` in the same order, so
one seed gives the same instance in both packages. ``hopcroft_karp`` is
the classic sequential algorithm (layered BFS to the shortest augmenting
distance, then augmentation along vertex-disjoint shortest paths). Its
depth-first search is iterative, with an explicit stack, so the long
alternating paths of a 4096² instance cannot reach Python's recursion
limit; it visits neighbours in the same order as the recursive original
and returns the same cardinality.
"""
from __future__ import annotations

import collections

import numpy as np


def hopcroft_karp(adj: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Maximum-cardinality bipartite matching of a dense bool adjacency.

    Args:
      adj: ``(nl, nr)`` bool — ``adj[i, j]`` iff left ``i`` ~ right ``j``.

    Returns ``(match_row, match_col, cardinality)`` with ``-1`` marking an
    unmatched vertex — the same convention as ``MatchingResult``.
    """
    adj = np.asarray(adj, bool)
    nl, nr = adj.shape
    nbrs = [np.nonzero(adj[i])[0].tolist() for i in range(nl)]
    match_row = np.full(nl, -1, np.int64)
    match_col = np.full(nr, -1, np.int64)
    INF = nl + nr + 1

    def bfs(dist: np.ndarray) -> bool:
        """Layer free rows into ``dist``; True iff some free col is
        reachable."""
        dist[:] = INF
        q = collections.deque()
        for i in range(nl):
            if match_row[i] < 0:
                dist[i] = 0
                q.append(i)
        found = False
        while q:
            i = q.popleft()
            for j in nbrs[i]:
                k = match_col[j]
                if k < 0:
                    found = True
                elif dist[k] == INF:
                    dist[k] = dist[i] + 1
                    q.append(k)
        return found

    def dfs(root: int, dist: np.ndarray) -> bool:
        """Augment along one layered path from free row ``root``.

        Each stack frame is ``[row, next neighbour position]``; a frame
        whose row found a path flips its edge on the way back up."""
        stack = [[root, 0]]
        while stack:
            frame = stack[-1]
            i, pos = frame
            if pos == len(nbrs[i]):        # no path through i
                dist[i] = INF
                stack.pop()
                continue
            j = nbrs[i][pos]
            frame[1] = pos + 1
            k = match_col[j]
            if k < 0:                      # free column: flip the path
                for r, p in reversed(stack):
                    c = nbrs[r][p - 1]
                    match_row[r], match_col[c] = c, r
                return True
            if dist[k] == dist[i] + 1:
                stack.append([int(k), 0])
        return False

    dist = np.full(nl, INF, np.int64)
    while bfs(dist):
        for i in range(nl):
            if match_row[i] < 0:
                dfs(i, dist)
    return match_row, match_col, int(np.sum(match_row >= 0))


# ------------------------------------------------------------- generators

def random_bipartite(rng: np.random.Generator, nl: int, nr: int,
                     p: float = 0.3) -> np.ndarray:
    """Erdős–Rényi bipartite adjacency: each edge present with prob ``p``."""
    return rng.random((nl, nr)) < p


def perfect_matching_instance(rng: np.random.Generator, n: int,
                              p_noise: float = 0.2) -> np.ndarray:
    """A hidden perfect matching (a random permutation) plus noise edges.

    Maximum cardinality is exactly ``n``: greedy initialization on the
    noise edges strands rows that only long alternating paths recover.
    """
    adj = rng.random((n, n)) < p_noise
    adj[np.arange(n), rng.permutation(n)] = True
    return adj


def star_instance(nl: int, nr: int, hub: int = 0) -> np.ndarray:
    """Every row adjacent to the single hub column only: max matching = 1."""
    adj = np.zeros((nl, nr), bool)
    adj[:, hub] = True
    return adj


def disconnected_instance(rng: np.random.Generator,
                          blocks: list[tuple[int, int]],
                          p: float = 0.5) -> np.ndarray:
    """Block-diagonal components (a zero block = isolated vertices)."""
    nl = sum(b[0] for b in blocks)
    nr = sum(b[1] for b in blocks)
    adj = np.zeros((nl, nr), bool)
    r = c = 0
    for bl, br in blocks:
        if bl and br:
            adj[r:r + bl, c:c + br] = rng.random((bl, br)) < p
        r, c = r + bl, c + br
    return adj
