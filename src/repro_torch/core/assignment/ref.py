"""Oracles of the assignment problem (numpy / scipy only).

The port's own copy of ``repro/core/assignment/ref.py``: the exact
max-weight perfect matching weight (scipy's Hungarian solver and a brute
force for tiny ``n``) and the paper's ε-optimality check of a final
pseudoflow.
"""
from __future__ import annotations

import itertools

import numpy as np
from scipy.optimize import linear_sum_assignment


def optimal_weight(w: np.ndarray) -> int:
    """Exact max-weight perfect matching weight via Hungarian (scipy)."""
    w = np.asarray(w)
    r, c = linear_sum_assignment(w, maximize=True)
    return int(w[r, c].sum())


def optimal_weight_bruteforce(w: np.ndarray) -> int:
    """Brute force for tiny n (cross-check for the cross-check)."""
    n = w.shape[0]
    best = -np.inf
    for perm in itertools.permutations(range(n)):
        best = max(best, sum(w[i, perm[i]] for i in range(n)))
    return int(best)


def eps_optimal(w: np.ndarray, F: np.ndarray, p_x: np.ndarray,
                p_y: np.ndarray, eps: int) -> bool:
    """Check the paper's ε-optimality invariant on the final pseudoflow."""
    n = w.shape[0]
    c = -(n + 1) * np.asarray(w, np.int64)
    cp = c + p_x[:, None].astype(np.int64) - p_y[None, :].astype(np.int64)
    fwd_ok = np.all(cp[F == 0] >= -eps)        # residual X->Y arcs
    rev_ok = np.all(-cp[F == 1] >= -eps)       # residual Y->X arcs
    return bool(fwd_ok and rev_ok)
