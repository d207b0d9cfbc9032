"""Bipartite maximum-cardinality matching: the solver and its oracle.

Counterpart of ``repro/core/matching/__init__.py``. It re-exports the
solver (``repro_torch.core.matching.bfs``) and the Hopcroft–Karp oracle.
It registers no solver kind: the registry, the batch front end and refill
are not ported yet (ROADMAP items M3 and M6).
"""
from __future__ import annotations

from repro_torch.core.matching.bfs import (MatchingResult, match_bipartite,
                                           match_bipartite_batch)
from repro_torch.core.matching.ref import hopcroft_karp

__all__ = ["MatchingResult", "match_bipartite", "match_bipartite_batch",
           "hopcroft_karp"]
