"""K3 ``bfs_relabel_sweeps`` and its drivers: the port against the JAX
package.

The same numpy inputs go through the JAX functions (the Pallas kernel in
interpret mode) and through the port on the CPU, where the wrapper runs
its plain PyTorch version: one sweep call, the balanced backend's
bidirectional fixpoint driver ``bfs_relabel_heights``, and the grid
solver's sink-only ``bfs_heights``, which the port runs on the same
kernel, including a binding ``max_iters``. Tolerance: exact equality
(``np.array_equal``, dtypes included); every value is an int32 height.
The kernel itself is held to its plain version on the card in
``test_torch_kernels_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same

from repro.core.maxflow import grid as jg
from repro.core.maxflow.ref import (checkerboard_problem, long_path_problem,
                                    random_grid_problem)
from repro.kernels.bfs_relabel import kernel as jk
from repro.kernels.bfs_relabel import ops as jops
from repro_torch.core.maxflow import grid as tg
from repro_torch.kernels.bfs_relabel import kernel as tk
from repro_torch.kernels.bfs_relabel import ops as tops

INF = 2 ** 30


def _stack(probs):
    """(cap (4, B, H, W), cs (B, H, W), ct (B, H, W)) numpy arrays."""
    return (np.stack([p[0] for p in probs], axis=1),
            np.stack([p[1] for p in probs]), np.stack([p[2] for p in probs]))


def _seeds(cs, ct, n):
    return (np.where(ct > 0, 1, INF).astype(np.int32),
            np.where(cs > 0, n + 1, INF).astype(np.int32))


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("H,W,B,seed", [(8, 8, 1, 0), (16, 32, 1, 1),
                                        (12, 12, 4, 3), (24, 16, 2, 4)])
def test_sweeps_match_jax(H, W, B, seed):
    probs = [random_grid_problem(np.random.default_rng(seed + b), H, W)
             for b in range(B)]
    cap, cs, ct = _stack(probs)
    n = H * W + 2
    seed_t, seed_s = _seeds(cs, ct, n)
    # mid-fixpoint planes: one JAX call in, then compare the next one
    dt, ds = jk.bfs_relabel_sweeps(*map(jnp.asarray, (cap, seed_t, seed_s,
                                                      seed_t, seed_s)),
                                   interpret=True)
    want = jk.bfs_relabel_sweeps(jnp.asarray(cap), jnp.asarray(seed_t),
                                 jnp.asarray(seed_s), dt, ds, interpret=True)
    got_t, got_s, changed = tk.bfs_relabel_sweeps(
        *_t(cap, seed_t, seed_s, np.asarray(dt), np.asarray(ds)))
    assert_same((got_t, got_s), want)
    moved = not (np.array_equal(want[0], dt) and np.array_equal(want[1], ds))
    assert changed.dtype == torch.int32 and int(changed) == int(moved)


def test_sweeps_sink_only_and_sweep_count():
    """ds off relaxes dt alone; k sweeps == k single sweeps; a fixpoint
    reports no change."""
    cap, cs, ct = random_grid_problem(np.random.default_rng(7), 16, 16)
    seed_t, _ = _seeds(cs, ct, 16 * 16 + 2)
    cap4, st = torch.tensor(cap)[:, None], torch.tensor(seed_t)[None]
    three, none_s, _ = tk.bfs_relabel_sweeps(cap4, st, None, st, None,
                                             sweeps=3)
    assert none_s is None
    one = st
    for _ in range(3):
        one, _, _ = tk.bfs_relabel_sweeps(cap4, st, None, one, None, sweeps=1)
    assert torch.equal(three, one)
    fix = st
    for _ in range(64):
        fix, _, _ = tk.bfs_relabel_sweeps(cap4, st, None, fix, None)
    again, _, changed = tk.bfs_relabel_sweeps(cap4, st, None, fix, None)
    assert torch.equal(again, fix) and int(changed) == 0


@pytest.mark.parametrize("maker,max_iters", [
    (lambda rng: random_grid_problem(rng, 16, 16), 0),
    (lambda rng: random_grid_problem(rng, 8, 24), 0),
    (lambda rng: long_path_problem(8, 8), 0),
    (lambda rng: checkerboard_problem(8, 8), 0),
    (lambda rng: checkerboard_problem(16, 16), 3),
    (lambda rng: long_path_problem(16, 16), 12)])
def test_heights_driver_matches_jax(maker, max_iters):
    """bfs_relabel_heights with a non-trivial h_prev; a max_iters of 3 or
    12 binds (the sweep count grows by SWEEPS per call in both)."""
    rng = np.random.default_rng(0)
    cap, cs, ct = maker(rng)
    H, W = cs.shape
    n = H * W + 2
    iters = max_iters or n
    h_prev = rng.integers(0, n, (H, W)).astype(np.int32)
    want = jops.bfs_relabel_heights(*map(jnp.asarray, (cap, cs, ct, h_prev)),
                                    n, iters, interpret=True)
    got = tops.bfs_relabel_heights(*_t(cap, cs, ct, h_prev), n, iters)
    assert_same(got, want)


def test_heights_driver_batched_matches_jax_and_singles():
    probs = [random_grid_problem(np.random.default_rng(9 + b), 10, 10)
             for b in range(3)]
    cap, cs, ct = _stack(probs)
    n = 102
    h_prev = np.zeros((3, 10, 10), np.int32)
    want = jops.bfs_relabel_heights(*map(jnp.asarray, (cap, cs, ct, h_prev)),
                                    n, n, interpret=True)
    got = tops.bfs_relabel_heights(*_t(cap, cs, ct, h_prev), n, n)
    assert_same(got, want)
    for b in range(3):
        single = tops.bfs_relabel_heights(
            *_t(cap[:, b], cs[b], ct[b], h_prev[b]), n, n)
        assert torch.equal(single, got[b])


@pytest.mark.parametrize("shape,max_iters", [((16, 16), 0), ((3, 16, 16), 0),
                                             ((16, 16), 3), ((2, 24, 8), 5),
                                             ((12, 20), 9)])
def test_bfs_heights_matches_jax(shape, max_iters):
    """The sink-only BFS on K3 (SWEEPS per call, the last call cut to the
    cap) equals the reference's one-sweep-per-iteration loop."""
    *b, H, W = shape
    probs = [random_grid_problem(np.random.default_rng(20 + i), H, W)
             for i in range(max(1, int(np.prod(b))))]
    cap, cs, ct = _stack(probs) if b else probs[0]
    n = H * W + 2
    iters = max_iters or n
    h_prev = np.random.default_rng(1).integers(0, 3 * n, shape).astype(
        np.int32)
    want = jg.bfs_heights(jnp.asarray(cap), jnp.asarray(ct),
                          jnp.asarray(h_prev), jnp.int32(n), iters)
    got = tg.bfs_heights(*_t(cap, ct, h_prev), n, iters)
    assert_same(got, want)


def test_sweeps_check_inputs():
    cap = torch.zeros((4, 1, 4, 4))
    st = torch.zeros((1, 4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="sweeps"):
        tk.bfs_relabel_sweeps(cap, st, st, st, st, sweeps=0)
    with pytest.raises(ValueError, match="both"):
        tk.bfs_relabel_sweeps(cap, st, None, st, st)
    with pytest.raises(ValueError, match="int32"):
        tk.bfs_relabel_sweeps(cap, st, st, st.float(), st)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tk.bfs_relabel_sweeps(cap.to("meta"), st.to("meta"), None,
                              st.to("meta"), None)
