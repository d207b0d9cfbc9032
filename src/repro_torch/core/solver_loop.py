"""Unified solver-loop runtime: masked iteration + early-exit compaction.

Counterpart of ``repro/core/solver_loop.py``. A solver registers one
heuristic cycle as a ``LoopSpec``:

* ``cycle(state) -> state``: one heuristic cycle, batch-polymorphic and
  PER-INSTANCE PURE (instance ``b`` of the output depends only on
  instance ``b`` of the input; a shared predicate inside, like a BFS
  fixpoint's ``changed``, may add no-op iterations but never changes an
  instance's values),
* ``live(state, rounds) -> (...,) bool``: the per-instance liveness mask,
* ``rounds_per_cycle``: the per-instance round-accounting increment,
* ``lead_axes_fn(leaf, batch_ndim) -> int``: how many leaf axes PRECEDE
  the batch axes (``None`` = batch leads every leaf),
* ``heur(state) -> (...,) int``: optional per-instance heuristic
  counters, folded into ``CycleEvent.heur_total`` for detail hooks.

and the runtime owns the iteration in one of two modes:

* ``run_masked``: every cycle computes the whole batch and ``freeze``
  selects the old state back in for non-live instances. The reference
  runs it on the device as a ``lax.while_loop``; here it is a host loop
  with the same cond-before-body structure and ONE liveness sync per
  cycle.
* ``run_compacted``: early-exit compaction. Between cycles the host
  gathers the still-live instances into a dense pow2-sized sub-batch
  (``bucket_size``), runs the SAME cycle on it and scatters the results
  back in input order, so converged instances stop costing device time.
  It also takes a REFILL hook: at the cycle boundary where the live set
  is re-gathered anyway, new instances may enter the slots converged ones
  left (``repro_torch.core.refill`` wraps the hook into a session).

Because cycles are per-instance pure, both modes run every instance's
exact trajectory: compacted == masked == a loop of single solves, values
and counters alike, and a refilled instance equals its closed-batch solve.

Lanes: ``run_compacted`` takes contiguous batch slices pinned to devices.
The entry points pass one lane on the solve's device, or under ``mesh=``
the lanes of ``repro_torch.launch.mesh.compact_lanes``.

Cycle telemetry (``cycle_events``): the compacted driver reads the live
set every cycle anyway and emits a ``CycleEvent`` per cycle whenever a
hook is installed; the masked driver emits only for ``masked=True`` hooks
(it then reads the whole mask instead of ``any``). The reference's
single-instance ``maxflow_grid`` and ``match_bipartite`` are jitted and so
never emit; the port's emit under a ``masked=True`` hook like every other
masked solve.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.masking import freeze, tree_leaves, tree_map


class CycleEvent(NamedTuple):
    """One structured per-cycle telemetry sample (``cycle_events``).

    Emitted BEFORE each cycle runs, by both drivers:

    * ``driver``: ``"masked"`` or ``"compacted"``.
    * ``cycle``: host cycle index, from 0.
    * ``n_live``: still-live instances entering this cycle (all lanes).
    * ``rounds_total``: sum of the per-slot rounds counters so far (with
      refill, counters describe current slot OCCUPANTS).
    * ``gathered``: instances this cycle computes: the padded pow2
      sub-batch total for the compacted driver, the full batch size for
      the masked driver (``gathered - n_live`` is the wasted work).
    * ``heur_total``: sum of the per-instance heuristic counters over the
      live set, or ``None`` when the spec registers no ``heur`` or the
      hook was installed without ``detail=True`` (one more device read
      per cycle).
    """

    driver: str
    cycle: int
    n_live: int
    rounds_total: int
    gathered: int
    heur_total: int | None


class _CycleHook(NamedTuple):
    fn: Callable          # CycleEvent -> None
    masked: bool          # also observe run_masked's cycles
    detail: bool          # read heur counters per cycle (a device read)


# Thread-local (a ContextVar): threads trace their own solves without
# seeing each other's cycles; the disabled cost is one read per solve.
_cycle_hook: contextvars.ContextVar["_CycleHook | None"] = \
    contextvars.ContextVar("solver_loop_cycle_hook", default=None)


@contextlib.contextmanager
def cycle_events(fn: Callable, *, masked: bool = False,
                 detail: bool = False):
    """Install ``fn(event: CycleEvent)`` as this thread's cycle hook.

    While active, every cycle of ``run_compacted`` emits one
    ``CycleEvent`` (all lanes aggregated) before it runs. With
    ``masked=True``, ``run_masked`` solves emit too, reading the whole
    liveness mask each cycle instead of its ``any``. With ``detail=True``,
    events include ``heur_total`` for specs that register a ``heur``
    extractor (one more device read per cycle).

    The hook must be cheap and must not raise.
    """
    token = _cycle_hook.set(_CycleHook(fn, masked, detail))
    try:
        yield
    finally:
        _cycle_hook.reset(token)


@contextlib.contextmanager
def trace_cycles(fn: Callable[[int, int], None]):
    """Back-compat shim over ``cycle_events``: ``fn(cycle_index, n_live)``.

    Equivalent to ``cycle_events`` with an adapter that drops every field
    but ``cycle`` and ``n_live``; masked solves do not emit.
    """
    with cycle_events(lambda ev: fn(ev.cycle, ev.n_live)):
        yield


def masked_events_active() -> bool:
    """Is a ``cycle_events(masked=True)`` hook installed on this thread?"""
    hook = _cycle_hook.get()
    return hook is not None and hook.masked


class LoopSpec(NamedTuple):
    """A solver's registration with the loop runtime.

    Built through a cached factory (``functools.lru_cache`` keyed by the
    solver's static knobs), so repeated solves hand the runtime the SAME
    spec object.
    """

    cycle: Callable        # state -> state, one heuristic cycle (all-live)
    live: Callable         # (state, rounds) -> (...,) bool per instance
    rounds_per_cycle: int
    lead_axes_fn: Callable | None = None   # (leaf, batch_ndim) -> int
    # optional per-instance heuristic-invocation counters, state -> (...,)
    # int (the grid solver's ``heur``); folded into CycleEvent.heur_total
    # for detail hooks
    heur: Callable | None = None


def _lead(spec: LoopSpec, batch_ndim: int):
    """Adapt the spec's (leaf, batch_ndim) signature to a (leaf,) closure."""
    if spec.lead_axes_fn is None:
        return None
    fn = spec.lead_axes_fn
    return lambda a: fn(a, batch_ndim)


def _device(state) -> torch.device:
    return tree_leaves(state)[0].device


def _host(t: torch.Tensor) -> np.ndarray:
    """One device -> host read."""
    return t.detach().cpu().numpy()


def run_masked(spec: LoopSpec, state, batch_shape: tuple):
    """Masked iteration: cycle the whole batch, freeze non-live instances.

    With ``batch_shape == ()`` the mask is the scalar predicate of a
    single-instance loop, so single and batched solves share one
    trajectory. Under a ``cycle_events(masked=True)`` hook each cycle
    emits a ``CycleEvent`` before it runs; the host then keeps its own
    copy of the rounds counters, so the only read per cycle is still the
    mask's (and the heuristic counters' under ``detail=True``).

    Returns ``(state, rounds)`` where ``rounds`` (int32, the batch shape)
    counts, per instance, the rounds executed while that instance was
    live.
    """
    hook = _cycle_hook.get()
    if hook is not None and not hook.masked:
        hook = None
    lead = _lead(spec, len(batch_shape))
    rounds = torch.zeros(batch_shape, dtype=torch.int32,
                         device=_device(state))
    n_total = int(np.prod(batch_shape, dtype=np.int64))
    rounds_h = np.zeros(batch_shape, np.int64)
    cycle = 0
    while True:
        lv = spec.live(state, rounds)
        if hook is None:
            if not bool(lv.any()):         # the one host sync of the cycle
                return state, rounds
        else:
            lv_h = _host(lv)               # the one host sync of the cycle
            if not lv_h.any():
                return state, rounds
            heur_total = None
            if hook.detail and spec.heur is not None:
                heur_total = int(np.sum(_heur_vals(spec, state) * lv_h))
            hook.fn(CycleEvent(
                driver="masked", cycle=cycle, n_live=int(np.sum(lv_h)),
                rounds_total=int(rounds_h.sum()), gathered=n_total,
                heur_total=heur_total))
            rounds_h += np.where(lv_h, spec.rounds_per_cycle, 0)
            cycle += 1
        state = freeze(lv, spec.cycle(state), state, lead_axes_fn=lead)
        rounds = rounds + torch.where(lv, spec.rounds_per_cycle, 0).to(
            torch.int32)


def bucket_size(n_live: int, cap: int) -> int:
    """Sub-batch size for ``n_live`` instances: next pow2, clamped to the
    lane size. The ladder {1, 2, 4, ..., cap} bounds the distinct sub-batch
    shapes each kernel is launched at to <= log2(cap) + 2."""
    p = 1 << max(0, n_live - 1).bit_length() if n_live > 1 else 1
    return min(p, cap)


def _tree_take(spec: LoopSpec, state, idx: torch.Tensor,
               batch_ndim: int = 1):
    """Gather instances ``idx`` from every leaf's batch axis (a copy)."""
    lead = _lead(spec, batch_ndim)
    return tree_map(
        lambda a: a.index_select(lead(a) if lead else 0, idx), state)


def _tree_put(spec: LoopSpec, state, idx: torch.Tensor, sub):
    """Write sub-batch ``sub`` into instances ``idx`` of ``state``, in
    place (``index_copy_``); returns ``state``. Only ever called on a lane
    state ``run_compacted`` owns: it copies the caller's state once at
    entry, where the reference's ``.at[].set`` is functional."""
    lead = _lead(spec, 1)
    tree_map(lambda a, s: a.index_copy_(lead(a) if lead else 0, idx, s),
             state, sub)
    return state


def _index(idx, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx, np.int64), device=device)


def _compact_step(spec: LoopSpec, state, rounds: torch.Tensor):
    """One cycle on an (all-live) compacted sub-batch + its next liveness."""
    new = spec.cycle(state)
    return new, spec.live(new, rounds + spec.rounds_per_cycle)


def _live_mask(spec: LoopSpec, state, rounds: torch.Tensor) -> np.ndarray:
    return _host(spec.live(state, rounds))


def _heur_vals(spec: LoopSpec, state) -> np.ndarray:
    """Per-instance heuristic-invocation counters (detail hooks only)."""
    return _host(spec.heur(state))


def _zeros_rounds(n: int, device: torch.device) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.int32, device=device)


def _emit_slot(spec: LoopSpec, refill, token, lane_state, slot: int,
               rounds_val: int) -> None:
    """Hand one finished instance (a batch-1 gather of its slot) to the
    hook."""
    refill.emit(token, _tree_take(spec, lane_state,
                                  _index([slot], _device(lane_state))),
                rounds_val)


def _admit_free(spec: LoopSpec, refill, lanes, lane_states, rounds,
                slot_token: list, live_idx: list, free_idx: list) -> None:
    """Offer freed slots to the refill hook until it declines or slots run
    out.

    Each admitted ``(token, state1)`` pair goes into the first free slot
    (moved to the lane's device first), its rounds counter reset to 0, and
    its liveness evaluated EXACTLY as an initial instance's would be:
    born-dead admissions are emitted at once with ``rounds == 0`` and never
    run a cycle, so an admitted instance's trajectory is a solo solve's.
    """
    while True:
        n_free = int(sum(f.size for f in free_idx))
        if n_free == 0:
            return
        new = refill.admit(n_free)
        if not new:
            return
        if len(new) > n_free:
            raise ValueError(
                f"refill.admit({n_free}) returned {len(new)} admissions; "
                f"it must return at most n_free")
        for token, st1 in new:
            i = next(j for j, f in enumerate(free_idx) if f.size)
            s = int(free_idx[i][0])
            free_idx[i] = free_idx[i][1:]
            lo, hi, dev = lanes[i]
            dev = _device(lane_states[i]) if dev is None else dev
            st1 = tree_map(lambda a: a.to(dev), st1)
            lane_states[i] = _tree_put(spec, lane_states[i],
                                       _index([s], dev), st1)
            rounds[lo + s] = 0
            slot_token[lo + s] = token
            if _live_mask(spec, st1, _zeros_rounds(1, dev))[0]:
                live_idx[i] = np.sort(np.concatenate(
                    [live_idx[i],
                     np.asarray([s], dtype=live_idx[i].dtype)]))
            else:
                _emit_slot(spec, refill, token, lane_states[i], s, 0)
                free_idx[i] = np.concatenate(
                    [free_idx[i], np.asarray([s], dtype=free_idx[i].dtype)])


def _compacted_event(spec: LoopSpec, hook: _CycleHook, cycle: int, lanes,
                     lane_states, live_idx, rounds) -> CycleEvent:
    """Build the pre-dispatch ``CycleEvent`` of one compacted host cycle."""
    gathered = sum(bucket_size(int(li.size), hi - lo)
                   for (lo, hi, _), li in zip(lanes, live_idx) if li.size)
    heur_total = None
    if hook.detail and spec.heur is not None:
        heur_total = 0
        for st, li in zip(lane_states, live_idx):
            if li.size:
                heur_total += int(_heur_vals(spec, st)[li].sum())
    return CycleEvent(
        driver="compacted", cycle=cycle,
        n_live=int(sum(li.size for li in live_idx)),
        rounds_total=int(rounds.sum()), gathered=gathered,
        heur_total=heur_total)


def run_compacted(spec: LoopSpec, state, n_instances: int, *, lanes=None,
                  refill=None):
    """Early-exit compaction over a 1-D batch axis of ``n_instances``.

    Between cycles the host gathers the still-live instances into a dense
    pow2-sized sub-batch (``bucket_size``), runs ``cycle`` on it, and
    scatters the results back in input order. Pad slots of a bucket
    duplicate a live instance and are never scattered back: cycles are
    per-instance pure, so duplicates cannot perturb real slots. When every
    instance of a lane is live and fills its bucket, the lane's state is
    cycled as it is (the gather would be the identity).

    Per cycle and lane the host reads the new live mask once; the rounds
    counters stay a numpy array on the host and the sub-batch's slice goes
    to the device once.

    Args:
      spec: the solver's ``LoopSpec``.
      state: batched solver state; every leaf's batch axis has size
        ``n_instances`` at position ``lead_axes_fn(leaf, 1)``. Never
        written: each lane works on its own copy.
      n_instances: the batch size B.
      lanes: optional list of ``(lo, hi, device)`` contiguous slices; each
        compacts on its own, instances never cross lanes (``device=None``:
        the state's device). Default: one lane over the whole batch.
      refill: optional continuous-batching hook, an object with
        ``admit(n_free) -> [(token, state1), ...]`` (called at every cycle
        boundary with free slots, before cycle 0 too; at most ``n_free``
        new batch-1 states, ``[]`` declines; the loop ends when nothing is
        live and the hook declines) and ``emit(token, state1, rounds)``
        (called exactly once per instance, the moment it leaves the live
        set, with a batch-1 gather of its final state and its rounds;
        initial instances carry their batch index as token, born-dead ones
        emit at once with ``rounds == 0``).

    Returns ``(state, rounds)``, as ``run_masked`` (int32 rounds on the
    state's device). With ``refill`` they describe the final slot
    occupants; per-instance results arrive through ``emit``.
    """
    home = _device(state)
    if lanes is None:
        lanes = [(0, n_instances, None)]
    rounds = np.zeros(n_instances, np.int32)
    slot_token: list = list(range(n_instances))

    lane_states, live_idx = [], []
    for lo, hi, dev in lanes:
        dev = home if dev is None else dev
        # the lane's own copy: scatters below write into it in place
        sub = _tree_take(spec, state, torch.arange(lo, hi, device=home))
        sub = tree_map(lambda a: a.to(dev), sub)
        lane_states.append(sub)
        live_idx.append(np.nonzero(
            _live_mask(spec, sub, _zeros_rounds(hi - lo, dev)))[0])

    free_idx: list = []
    if refill is not None:
        # born-dead initial instances emit at once (rounds = 0) and free
        # their slots for admission before the first cycle
        for i, (lo, hi, _) in enumerate(lanes):
            dead = np.setdiff1d(np.arange(hi - lo, dtype=np.int64),
                                live_idx[i])
            for s in dead:
                _emit_slot(spec, refill, slot_token[lo + int(s)],
                           lane_states[i], int(s), 0)
            free_idx.append(dead)
        _admit_free(spec, refill, lanes, lane_states, rounds, slot_token,
                    live_idx, free_idx)

    hook = _cycle_hook.get()
    cycle = 0
    while any(li.size for li in live_idx):
        if hook is not None:
            hook.fn(_compacted_event(spec, hook, cycle, lanes, lane_states,
                                     live_idx, rounds))
        cycle += 1
        pending: list = [None] * len(lanes)
        for i, (lo, hi, _) in enumerate(lanes):
            li = live_idx[i]
            if not li.size:
                continue
            dev = _device(lane_states[i])
            m = bucket_size(int(li.size), hi - lo)
            pad = np.concatenate(
                [li, np.full(m - li.size, li[0], dtype=li.dtype)])
            r = torch.from_numpy(rounds[lo:hi][pad]).to(dev)
            if m == hi - lo and li.size == m:     # all live: no gather
                lane_states[i], lv = _compact_step(spec, lane_states[i], r)
            else:
                # both index copies go to the device before the cycle, so
                # none waits for the cycle's kernels
                take, put = _index(pad, dev), _index(li, dev)
                new_sub, lv = _compact_step(
                    spec, _tree_take(spec, lane_states[i], take), r)
                # scatter ONLY the real slots: pad duplicates must not
                # overwrite their source instance with an extra cycle
                if m > li.size:
                    new_sub = _tree_take(spec, new_sub,
                                         torch.arange(li.size, device=dev))
                lane_states[i] = _tree_put(spec, lane_states[i], put,
                                           new_sub)
            pending[i] = lv
        for i, lv in enumerate(pending):   # host sync point, all lanes in
            if lv is None:
                continue
            li = live_idx[i]
            lo = lanes[i][0]
            rounds[lo + li] += spec.rounds_per_cycle
            keep_mask = _host(lv)[:li.size]
            live_idx[i] = li[keep_mask]
            if refill is not None:
                done = li[~keep_mask]
                for s in done:
                    _emit_slot(spec, refill, slot_token[lo + int(s)],
                               lane_states[i], int(s),
                               int(rounds[lo + int(s)]))
                free_idx[i] = np.concatenate([free_idx[i], done])
        if refill is not None:
            _admit_free(spec, refill, lanes, lane_states, rounds,
                        slot_token, live_idx, free_idx)

    # Reassemble in input order (lanes are contiguous, ordered slices).
    if len(lane_states) > 1:
        lead = _lead(spec, 1)
        parts = [tree_map(lambda a: a.to(home), s) for s in lane_states]
        state = tree_map(
            lambda *xs: torch.cat(xs, dim=lead(xs[0]) if lead else 0),
            *parts)
    else:
        state = lane_states[0]
    return state, torch.from_numpy(rounds).to(home)
