"""Closed loop: one batch at a time, the next dispatched when the last
one's answers are on the host, cycling through the pool of batches."""
from __future__ import annotations

import time
from typing import NamedTuple


class Window(NamedTuple):
    t0: float             # host clock at the window's start
    deadline: float | None
    records: list         # every batch dispatched, in order
    next_index: int       # the pool position the next batch would take

    @property
    def done(self) -> list:
        """The batches whose answers came before the deadline."""
        return [r for r in self.records
                if self.deadline is None or r.t_done <= self.deadline]


def run(server, *, seconds: float | None = None,
        batches: int | None = None, start: int = 0) -> Window:
    """Dispatch batches back to back for ``seconds`` (a batch started
    before the deadline is waited for) or for exactly ``batches``."""
    records = []
    i = start
    t0 = time.perf_counter()
    deadline = None if seconds is None else t0 + seconds
    while True:
        if deadline is not None and time.perf_counter() >= deadline:
            break
        if batches is not None and len(records) >= batches:
            break
        records.append(server.solve(i % server.pool_size))
        i += 1
    return Window(t0=t0, deadline=deadline, records=records, next_index=i)
