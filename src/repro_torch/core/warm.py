"""Incremental re-solve: graph deltas, a solution cache, and the generic
warm-start driver over the ``SolverKind`` warm seam.

Counterpart of ``repro/core/warm.py``. A production graph mutates and is
asked again; restarting from the previous solution beats a cold solve
when the delta is small. This module is the kind-agnostic half:

* ``GraphDelta``: a sparse edit (set semantics) against a validated
  payload; ``apply_delta`` materializes the mutated payload and
  re-validates it.
* ``WarmStart``: what a warm instance carries into a solve: the cached
  prior ``solution`` (the kind's ``solution_of`` artifact), optionally the
  ``base_problem`` it solved and a precomputed ``delta_bound``.
* ``content_key`` / ``delta_bound``: graph identity (a hash of the leaf
  bytes, the reference's digest for the same leaves) and the largest
  per-entry change, both over the leaves in ``jax.tree.leaves`` order
  (``repro_torch.core.masking.tree_flatten``).
* ``SolutionCache``: content-hash keyed, LRU with entry and byte budgets;
  evicted entries spill through ``repro_torch.checkpoint.store.put`` /
  ``get`` and are reloaded on a hit.
* ``solve_warm``: pads warm and cold instances into the SAME buckets,
  builds per-instance states through the kind's ``init_state`` /
  ``warm_state`` hooks, and drives the unchanged masked, compacted or
  per-lane compacted loop from that state. Contract: a warm solve reaches
  the optimum a cold solve of the mutated graph reaches, for every kind
  and driver, and equals the reference's warm solve leaf for leaf.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.kinds import get_kind
from repro_torch.core.masking import (tree_flatten, tree_leaves, tree_map,
                                      tree_unflatten)
from repro_torch.core.solver_loop import run_masked

__all__ = [
    "GraphDelta", "apply_delta", "WarmStart", "SolutionCache",
    "content_key", "delta_bound", "solve_warm",
]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class GraphDelta(NamedTuple):
    """One sparse edit against a validated payload (SET semantics).

    ``field`` selects a payload component by attribute name for structured
    payloads (``"cap_nbr"`` / ``"cap_src"`` / ``"cap_sink"`` of a maxflow
    ``GridProblem``); ``None`` addresses the payload itself when it is one
    array (the assignment weights, the dense matching adjacency). ``idx``
    is a tuple of integer index arrays, one per axis of the addressed
    array (numpy advanced indexing); ``values`` are the new entries.
    Deltas never change shape.
    """

    idx: tuple
    values: Any
    field: str | None = None


def apply_delta(kind: str, payload, delta) -> Any:
    """Apply one ``GraphDelta`` (or a sequence, in order) to ``payload``;
    returns the mutated, RE-VALIDATED payload (numpy leaves). The input
    payload is never aliased."""
    k = get_kind(kind)
    out = k.validate(payload)
    deltas = [delta] if isinstance(delta, GraphDelta) else list(delta)
    for d in deltas:
        if not isinstance(d, GraphDelta):
            raise TypeError(f"expected GraphDelta, got {type(d).__name__}")
        if d.field is None:
            arr = np.array(out, copy=True)
            arr[tuple(np.asarray(i) for i in d.idx)] = d.values
            out = arr
        else:
            if not hasattr(out, d.field):
                raise ValueError(
                    f"{kind!r} payload has no field {d.field!r} "
                    f"(fields: {getattr(out, '_fields', ())})")
            arr = np.array(getattr(out, d.field), copy=True)
            arr[tuple(np.asarray(i) for i in d.idx)] = d.values
            out = out._replace(**{d.field: arr})
    return k.validate(out)


class WarmStart(NamedTuple):
    """Warm-start directive for one instance (see module docstring).

    ``delta_bound``: an upper bound on the largest per-entry change
    between ``base_problem`` and the instance's payload; kinds use it to
    pick how much of their schedule to skip (the assignment ε ladder).
    ``None`` means: compute it from ``base_problem``, or be conservative.
    """

    solution: Any
    base_problem: Any = None
    delta_bound: float | None = None


def content_key(kind: str, payload) -> str:
    """Content-hash graph identity of a VALIDATED payload.

    Two payloads with equal leaf bytes (dtype, shape, values) get the same
    key whatever their object identity or array type (numpy or tensor on
    any device), and the same key as the reference's ``content_key``: the
    sha256 of the kind, then per leaf its numpy dtype string, ``repr`` of
    its shape and its C-contiguous bytes.
    """
    h = hashlib.sha256(kind.encode())
    for leaf in tree_leaves(payload):
        a = np.ascontiguousarray(_host(leaf))
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def delta_bound(new_payload, base_payload) -> float:
    """Max per-entry absolute change between two same-shape payloads, in
    float64 on the host. Two bool leaves (adjacencies) differ by 0 or 1
    per entry, so they are compared as they are, without the float64
    copies: the same bound at a fraction of the host time."""
    bound = 0.0
    new_leaves = tree_leaves(new_payload)
    base_leaves = tree_leaves(base_payload)
    if len(new_leaves) != len(base_leaves):
        raise ValueError("payloads differ in structure; no delta bound")
    for n, b in zip(new_leaves, base_leaves):
        na, ba = _host(n), _host(b)
        if na.shape != ba.shape:
            raise ValueError(
                f"payload leaves differ in shape ({na.shape} vs {ba.shape}); "
                f"deltas never change shape")
        if not na.size:
            continue
        if na.dtype == ba.dtype == np.bool_:
            d = float(np.any(na != ba))
        else:
            d = float(np.max(np.abs(na.astype(np.float64)
                                    - ba.astype(np.float64))))
        bound = max(bound, d)
    return bound


class _Entry(NamedTuple):
    kind: str
    problem: Any      # the validated payload the solution solves
    solution: Any     # the kind's solution_of artifact
    nbytes: int


def _tree_nbytes(tree) -> int:
    return int(sum(leaf.numel() * leaf.element_size()
                   if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
                   .nbytes for leaf in tree_leaves(tree)))


class SolutionCache:
    """LRU solution cache keyed by content-hash graph identity.

    Budgets: at most ``max_entries`` entries and ``max_bytes`` total leaf
    bytes in memory; the least-recently-used entries beyond either budget
    are dropped or, with ``spill_dir``, written through
    ``repro_torch.checkpoint.store.put`` and reloaded (and promoted back
    to memory, as numpy leaves) when hit again. The sole entry is never
    evicted. ``hits`` / ``misses`` count ``get`` outcomes.
    """

    def __init__(self, *, max_entries: int = 128,
                 max_bytes: int = 64 << 20, spill_dir: str | None = None):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self.spill_dir = spill_dir
        self._mem: OrderedDict[str, _Entry] = OrderedDict()
        # spilled entries keep their STRUCTURE here; the leaves live on
        # disk under the same key
        self._spilled: dict[str, tuple] = {}
        # several threads may share one cache
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem) + len(self._spilled)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._mem.values())

    def key(self, kind: str, payload) -> str:
        return content_key(kind, get_kind(kind).validate(payload))

    def put(self, kind: str, payload, solution) -> str:
        """Cache ``solution`` for the validated ``payload``; returns key."""
        problem = get_kind(kind).validate(payload)
        key = content_key(kind, problem)
        entry = _Entry(kind=kind, problem=problem, solution=solution,
                       nbytes=_tree_nbytes(problem) + _tree_nbytes(solution))
        with self._lock:
            self._spilled.pop(key, None)
            self._mem[key] = entry
            self._mem.move_to_end(key)
            self._shrink()
        return key

    def get(self, key: str) -> _Entry | None:
        """Entry for ``key`` (memory or spill); ``None`` and a miss if
        absent."""
        with self._lock:
            entry = self._mem.get(key)
            if entry is not None:
                self._mem.move_to_end(key)
                self.hits += 1
                return entry
            entry = self._unspill(key)
            if entry is not None:
                self.hits += 1
                return entry
            self.misses += 1
            return None

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._mem), "spilled": len(self._spilled),
                "nbytes": sum(e.nbytes for e in self._mem.values()),
                "hits": self.hits, "misses": self.misses,
                "hit_rate": (self.hits / total) if total else None,
            }

    def _shrink(self) -> None:
        while (len(self._mem) > self.max_entries
               or self.nbytes > self.max_bytes):
            if len(self._mem) == 1 and len(self._mem) <= self.max_entries:
                break                       # never evict the sole entry
            key, entry = self._mem.popitem(last=False)
            self._spill(key, entry)

    def _spill(self, key: str, entry: _Entry) -> None:
        if self.spill_dir is None:
            return                          # plain eviction
        from repro_torch.checkpoint import store
        p_leaves, p_def = tree_flatten(entry.problem)
        s_leaves, s_def = tree_flatten(entry.solution)
        store.put(self.spill_dir, key, list(p_leaves) + list(s_leaves))
        self._spilled[key] = (entry.kind, p_def, s_def, len(p_leaves),
                              entry.nbytes)

    def _unspill(self, key: str) -> _Entry | None:
        meta = self._spilled.get(key)
        if meta is None:
            return None
        from repro_torch.checkpoint import store
        leaves = store.get(self.spill_dir, key)
        if leaves is None:                  # spill file vanished
            del self._spilled[key]
            return None
        kind, p_def, s_def, n_p, nbytes = meta
        entry = _Entry(kind=kind,
                       problem=tree_unflatten(p_def, leaves[:n_p]),
                       solution=tree_unflatten(s_def, leaves[n_p:]),
                       nbytes=nbytes)
        del self._spilled[key]
        self._mem[key] = entry              # promote back to memory
        self._shrink()
        return entry


# --------------------------------------------------------------- the driver


def _lead_axis(spec, leaf, batch_ndim: int = 1) -> int:
    fn = spec.lead_axes_fn
    return fn(leaf, batch_ndim) if fn is not None else 0


def _concat_states(spec, states1: list):
    """Concatenate batch-1 states along each leaf's batch axis."""
    if len(states1) == 1:
        return states1[0]
    return tree_map(lambda *xs: torch.cat(xs, dim=_lead_axis(spec, xs[0])),
                    *states1)


def build_warm_state(kind_obj, rt, warm_fn, problem1, payload, ws, bshape):
    """One warm instance's state: resolve the base, bound the delta, call
    the kind's ``warm_state`` hook. Shared by ``solve_warm`` and the
    refill session's warm admissions."""
    base1, bound = None, ws.delta_bound
    if ws.base_problem is not None:
        base = kind_obj.validate(ws.base_problem)
        if bound is None:
            bound = delta_bound(payload, base)
        base1 = rt.pad_one(base, bshape)
    return warm_fn(problem1, ws.solution, base_problem1=base1,
                   delta_bound=bound)


def solve_warm(kind: str, payloads: Sequence, warm: dict | None = None, *,
               bucket: str = "max", compact: bool = False, mesh=None,
               mesh_axis: str | None = None, stats_out: list | None = None,
               **solver_kw) -> list:
    """Solve ``payloads`` with per-instance warm starts mixed into the
    ordinary cold buckets; returns per-payload results in input order.

    ``warm`` maps payload positions to ``WarmStart``s; positions absent
    from it are cold-initialized through the kind's ``init_state`` hook,
    inside the SAME bucket. Drivers: the masked loop by default,
    ``run_compacted`` under ``compact=True``, per-lane compacted lanes
    when ``mesh`` (a ``repro_torch.launch.mesh.SolverMesh``) is given, the
    bucket padded with inert instances to the lane count. ``stats_out``
    receives one ``BucketStats`` per bucket, as the reference's does.
    ``device=`` rides in ``**solver_kw``, like the other solver knobs.
    """
    from repro_torch.core.batch import BucketStats, _bucket_shape
    from repro_torch.core.solver_loop import _tree_take, run_compacted

    k = get_kind(kind)
    for hook in ("refill", "init_state", "warm_state"):
        if getattr(k, hook) is None:
            raise ValueError(
                f"solver kind {kind!r} registered no {hook!r} hook; it "
                f"cannot warm-start (serve it cold through solve_batch)")
    warm = dict(warm or {})
    for pos in warm:
        if not 0 <= pos < len(payloads):
            raise ValueError(
                f"warm position {pos} out of range for "
                f"{len(payloads)} payloads")
        if not isinstance(warm[pos], WarmStart):
            raise TypeError(
                f"warm[{pos}] must be a WarmStart, "
                f"got {type(warm[pos]).__name__}")

    rt = k.refill(**solver_kw)
    init_fn = k.init_state(**solver_kw)
    warm_fn = k.warm_state(**solver_kw)
    validated = [k.validate(p) for p in payloads]
    shapes = [rt.shape_of(p) for p in validated]
    if not validated:
        return []

    # group positions by bucket shape: warm and cold share buckets
    ndim = len(shapes[0])
    max_shape = tuple(max(s[d] for s in shapes) for d in range(ndim))
    groups: dict[tuple, list[int]] = {}
    for i, s in enumerate(shapes):
        groups.setdefault(_bucket_shape(s, bucket, max_shape), []).append(i)

    results: dict[int, Any] = {}
    for bshape, idxs in groups.items():
        problems1 = {i: rt.pad_one(validated[i], bshape) for i in idxs}
        states1 = []
        for i in idxs:
            if i in warm:
                states1.append(build_warm_state(
                    k, rt, warm_fn, problems1[i], validated[i], warm[i],
                    bshape))
            else:
                states1.append(init_fn(problems1[i]))
        n = len(idxs)
        if mesh is not None:
            # pad with inert instances so the batch divides into the
            # lanes, as solve_batch's lane path does
            from repro_torch.launch.mesh import compact_lanes, shard_count
            n_pad = -n % shard_count(mesh, mesh_axis)
            for _ in range(n_pad):
                states1.append(
                    init_fn(rt.pad_one(k.inert_problem(bshape), bshape)))
            state = _concat_states(rt.spec, states1)
            state, rounds = run_compacted(
                rt.spec, state, n + n_pad,
                lanes=compact_lanes(mesh, mesh_axis, n + n_pad))
        elif compact:
            state = _concat_states(rt.spec, states1)
            state, rounds = run_compacted(rt.spec, state, n)
        else:
            state = _concat_states(rt.spec, states1)
            state, rounds = run_masked(rt.spec, state, (n,))

        dev = rounds.device
        for b, i in enumerate(idxs):
            state1 = _tree_take(rt.spec, state,
                                torch.tensor([b], device=dev))
            res1 = rt.finalize(problems1[i], state1, rounds[b:b + 1])
            results[i] = rt.crop(res1, shapes[i], validated[i])
        if stats_out is not None:
            r = rounds.cpu().numpy()
            conv = sum(bool(results[i].converged) for i in idxs
                       if hasattr(results[i], "converged"))
            stats_out.append(BucketStats(
                kind=kind, shape=bshape, n_real=n, n_pad=0,
                compact=bool(compact or mesh is not None),
                rounds_min=int(r.min()), rounds_max=int(r.max()),
                rounds_mean=float(r.mean()), n_converged=int(conv)))
    return [results[i] for i in range(len(payloads))]
