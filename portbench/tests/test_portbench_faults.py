"""``correct`` comes out false when the timed path is broken underneath:
a step that returns its state unchanged, half of the batch left out (its
answers taken from the other half), an answer altered where it is
produced. (The cells run on one card: there is no exchange between
cards to leave out.) Each runs the harness on the CPU at a tiny size,
past its look for a card."""
from __future__ import annotations

import json

import pytest
import torch

from portbench.tests.conftest import TINY, make_tiny_root
from portbench.tests.test_portbench_harness import run_cell

GRID, ASSIGN = "grid512-grabcut.b32", "assign512-u100.b64"


@pytest.fixture
def root(tmp_path):
    """Tiny cells with a low round cap, so that a solve that never
    converges ends soon."""
    tiny = {GRID: ({**TINY[GRID][0], "solver": {
        "backend": "pallas", "rounds_per_heuristic": 32,
        "max_rounds": 512}}, TINY[GRID][1]),
        ASSIGN: ({**TINY[ASSIGN][0], "solver": {
            "method": "auction", "backend": "pallas", "alpha": 10,
            "rounds_per_heuristic": 16, "max_rounds": 256}},
            TINY[ASSIGN][1])}
    return make_tiny_root(tmp_path, tiny)


@pytest.fixture
def fresh_specs():
    """The solvers' cached loop specs hold the round functions they were
    built with: a patch is seen once they are rebuilt (this fixture's
    function), and the real ones return after the test."""
    from repro_torch.core.assignment.cost_scaling import _assignment_spec
    from repro_torch.core.maxflow.grid import _grid_spec

    def rebuild():
        for f in (_grid_spec, _assignment_spec):
            f.cache_clear()
    yield rebuild
    rebuild()


def _unchanged_step(monkeypatch, cell):
    if cell == GRID:
        import repro_torch.kernels.grid_push.ops as ops
        monkeypatch.setattr(ops, "jacobi_round_pallas",
                            lambda state, n_nodes: state)
    else:
        import repro_torch.core.assignment.cost_scaling as cs
        monkeypatch.setattr(cs, "_round_auction",
                            lambda c, eps, st, backend="xla": st)


def _half_left_out(monkeypatch, cell):
    import repro_torch.core.batch as batch
    real = batch.solve_prepared

    def half(prep, **kw):
        n = len(prep.idxs)
        keep = n // 2
        stacked = (type(prep.stacked)(*(a[:keep] for a in prep.stacked))
                   if isinstance(prep.stacked, tuple) else
                   prep.stacked[:keep])
        originals = None if prep.originals is None else \
            prep.originals[:keep]
        out, stats = real(prep._replace(
            idxs=prep.idxs[:keep], shapes=prep.shapes[:keep],
            stacked=stacked, originals=originals), **kw)
        for j in range(keep, n):
            out[prep.idxs[j]] = out[prep.idxs[j - keep]]
        return out, stats
    monkeypatch.setattr(batch, "solve_prepared", half)


def _answer_altered(monkeypatch, cell):
    if cell == GRID:
        import repro_torch.core.maxflow.grid as grid
        real = grid._grid_finalize

        def finalize(state, rounds, **kw):
            res = real(state, rounds, **kw)
            return res._replace(flow=res.flow + 1.0)
        monkeypatch.setattr(grid, "_grid_finalize", finalize)
    else:
        import repro_torch.core.assignment.cost_scaling as cs
        real = cs._assignment_finalize

        def finalize(w, st):
            res = real(w, st)
            col = res.col_of_row.clone()
            col[..., [0, 1]] = col[..., [1, 0]]
            return res._replace(col_of_row=col)
        monkeypatch.setattr(cs, "_assignment_finalize", finalize)


@pytest.mark.parametrize("cell", [GRID, ASSIGN])
@pytest.mark.parametrize("fault", [_unchanged_step, _half_left_out,
                                   _answer_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_makes_the_run_incorrect(root, monkeypatch, fresh_specs,
                                       cell, fault):
    assert run_cell(root, cell)["correct"]
    fault(monkeypatch, cell)
    fresh_specs()
    res = run_cell(root, cell)
    assert res["correct"] is False
    assert res["failed"] > 0
    over = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert over, json.dumps(res["checks"])
