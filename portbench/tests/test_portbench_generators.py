"""The generators: the same seed gives the same instances, and every
grid instance's max-flow stays below 2**24."""
from __future__ import annotations

import json

import numpy as np
import pytest

from portbench.generators import grabcut, uniform_weights
from portbench.tests.conftest import REPO


def config(name):
    return json.loads((REPO / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def small_grid(h=20, w=28):
    return {**config("grid-grabcut-512"), "height": h, "width": w}


TRAFFIC = {"batch": 3, "pool_batches": 2, "instance": {"gamma": 50}}


def flat(pool):
    return [np.concatenate([np.ravel(a) for a in inst]) if
            isinstance(inst, tuple) else np.ravel(inst)
            for batch in pool for inst in batch]


@pytest.mark.parametrize("make,cfg", [
    (grabcut.make_pool, small_grid()),
    (uniform_weights.make_pool, {**config("assign-u100-512"), "n": 16}),
])
def test_same_seed_same_instances(make, cfg):
    a = flat(make(cfg, TRAFFIC, 2 ** 31 + 99, "cpu"))
    b = flat(make(cfg, TRAFFIC, 2 ** 31 + 99, "cpu"))
    c = flat(make(cfg, TRAFFIC, 7, "cpu"))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert len(a) == 6


def test_weights_in_range_and_int32():
    cfg = {**config("assign-u100-512"), "n": 32}
    pool = uniform_weights.make_pool(cfg, TRAFFIC, 5, "cpu")
    w = np.stack([m for b in pool for m in b])
    assert w.dtype == np.int32 and w.min() >= 0 and w.max() <= 100


def test_grid_instances_integer_and_bounded():
    pool = grabcut.make_pool(small_grid(), TRAFFIC, 3, "cpu")
    for cap, cs, ct in (i for b in pool for i in b):
        for a in (cap, cs, ct):
            assert a.dtype == np.float32 and (a >= 0).all()
            assert np.array_equal(a, np.round(a))
        assert (np.minimum(cs, ct) == 0).all()   # one t-link a pixel
        assert cs.max() <= 63 and ct.max() <= 63


def test_full_size_max_flow_below_2_24():
    """At 512 x 512 the source edges alone bound every max-flow: 2**18
    pixels of at most ``tlink_max`` each."""
    cfg = config("grid-grabcut-512")
    top = cfg["assumed"]["generator"]["tlink_max"]
    assert cfg["height"] * cfg["width"] * top < 2 ** 24
    pool = grabcut.make_pool(cfg, {**TRAFFIC, "batch": 2,
                                   "pool_batches": 1}, 11, "cpu")
    for inst in pool[0]:
        assert grabcut.max_flow_bound(inst) < 2 ** 24
