"""Decides ``correct``: the program's answers against the plain reference.

Over every answer of the run: instances not converged, and instances
whose answers differ between two solves of the same pool batch. Over a
sample drawn from the seed (one instance from each of ``SAMPLE`` equal
stretches of the batch axis, each from a batch chosen at random, and the
instance with the most rounds): the kind's comparison with the reference,
run on the card after the window. Each number has its limit; the run is
correct when none is over it.
"""
from __future__ import annotations

import numpy as np

GLOBAL_LIMITS = {
    "unconverged": 0,    # answered instances that did not converge
    "repeat_diff": 0,    # instances answered differently on a repeat
}


def draw_sample(seed: int, records: list, batch: int, k: int) -> list:
    """``(record index, position)`` pairs: one position in each of ``k``
    stretches of the batch axis, in a record drawn from the seed, and the
    first instance with the most rounds; no pool instance twice."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, 0x5EED])
    picks = []
    for j in range(k):
        lo, hi = j * batch // k, (j + 1) * batch // k
        picks.append((int(rng.integers(len(records))),
                      int(rng.integers(lo, max(hi, lo + 1)))))
    rounds = [r.answers["rounds"] for r in records]
    ri = int(np.argmax([x.max() for x in rounds]))
    picks.append((ri, int(np.argmax(rounds[ri]))))
    seen, out = set(), []
    for ri, pos in picks:
        key = (records[ri].pool_index, pos)
        if key not in seen:
            seen.add(key)
            out.append((ri, pos))
    return out


def _unequal(a: dict, b: dict, pos: int) -> bool:
    return any(not np.array_equal(a[k][pos], b[k][pos]) for k in a)


def whole_run(records: list) -> dict:
    """The numbers of ``GLOBAL_LIMITS`` over every answer of the run."""
    first: dict = {}
    repeat = 0
    for r in records:
        ref = first.setdefault(r.pool_index, r)
        if ref is not r:
            repeat += sum(_unequal(r.answers, ref.answers, p)
                          for p in range(r.n))
    return {"unconverged": int(sum((~r.answers["converged"]).sum()
                                   for r in records)),
            "repeat_diff": int(repeat)}


def sampled(kind, instances: list, got: list, want: list,
            device) -> tuple[dict, int]:
    """The kind's numbers summed over the sampled instances, and how many
    of them failed at least one."""
    total = {k: 0 for k in kind.LIMITS}
    failed = 0
    for inst, g, w in zip(instances, got, want):
        one = kind.compare([inst], [g], [w], device)
        failed += any(one[k] > kind.LIMITS[k] for k in one)
        for k, v in one.items():
            total[k] += v
    return total, failed


def verdict(readings: dict, limits: dict) -> bool:
    return all(readings[k] <= limits[k] for k in limits)
