"""The count functions reproduce the hand-worked figures at the port's
smoke shapes (K1, K3 at 4 x 512^2; K4 at 8 x 512^2)."""
from __future__ import annotations

import pytest

from portbench import peaks
from portbench.counts import kernels, solve

H100 = peaks.for_card("NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("count,nbytes,ms", [
    (kernels.k1(4 * 512 * 512), 62_914_560, 0.0188),
    (kernels.k3(4 * 512 * 512), 29_360_128, 0.0088),
    (kernels.k4(8, 512), 10_551_296, 0.0031),
])
def test_kernel_counts(count, nbytes, ms):
    assert count[0] == nbytes
    assert round(peaks.least_s(*count, H100) * 1e3, 4) == ms


def test_k3_is_bound_by_bytes_until_many_sweeps():
    nodes = 4 * 512 * 512
    by_bytes = kernels.k3(nodes)[0] / H100["hbm_bytes_per_s"]
    assert peaks.least_s(*kernels.k3(nodes), H100) == by_bytes
    assert peaks.least_s(*kernels.k3(nodes, 64), H100) > by_bytes


def test_whole_solve_counts():
    b, o = solve.grid_instance(512, 512, rounds=100, heuristics=3)
    nodes = 512 * 512
    assert b == nodes * (24 + 1 + 64 * 100 + 28 * 5)
    assert o == nodes * (50 * 100 + 18 * 5)
    b, o = solve.assignment_instance(512, rounds=40, rounds_per_heuristic=16)
    e = 512 * 512
    assert b == 4 * e + 40 * (4 * e + 24 * 512) + 3 * 4 * e + 4 * 512
    assert o == 4 * e * 40 + 4 * e * 3


def test_unknown_card_has_no_peaks():
    assert peaks.for_card("cpu") is None
