"""The control, the reference one precision below the configuration's in
the program's place, fails the comparison; the reference in the stated
precision agrees with the program (both on the CPU, at a size a test run
holds: the assignment at n = 336, where int16 can no longer hold the
scaled costs, as at the cell's n = 512)."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import control
from portbench.tests.conftest import make_tiny_root

GRID, ASSIGN = "grid512-grabcut.b32", "assign512-u100.b64"
SIZES = {
    GRID: ({"height": 40, "width": 56},
           {"batch": 4, "pool_batches": 2, "trace_batches": 1}),
    ASSIGN: ({"n": 336}, {"batch": 2, "pool_batches": 1,
                          "trace_batches": 1}),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("control"), SIZES)


@pytest.mark.parametrize("cell", [GRID, ASSIGN])
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 3, 977])
def test_control_fails(root, cell, seed):
    r = control.readings(root, cell, seed, torch.device("cpu"))
    assert r["control_failed"], json.dumps(r)
    assert r["failed_instances"] > 0


@pytest.mark.parametrize("cell", [GRID, ASSIGN])
def test_reference_agrees_with_the_program(root, cell):
    """The reference's answers equal the program's on the same instances
    (the program on the CPU: the kernels' plain versions)."""
    from portbench import registry
    from repro_torch.core.batch import prepare_buckets, solve_prepared
    bench = registry.Bench(root)
    w = bench.cell(cell)
    config = bench.config(w["config"])
    traffic = bench.traffic(w["traffic"])
    kind = bench.part("kinds", config["kind"])
    pool = bench.part("generators", config["generator"]).make_pool(
        config, traffic, 4242, "cpu")
    batch = pool[0]
    (prep,) = prepare_buckets(config["kind"], batch)
    out, _ = solve_prepared(prep, device="cpu", **config["solver"])
    ans = kind.answers([out[i] for i in range(len(batch))])
    got = [kind.one(ans, i) for i in range(len(batch))]
    want = kind.reference_answers(config, batch, torch.device("cpu"))
    numbers = kind.compare(batch, got, want, torch.device("cpu"))
    assert all(v == 0 for v in numbers.values()), numbers
    for g, x in zip(got, want):
        for k in g:
            assert np.array_equal(g[k], x[k]), k
