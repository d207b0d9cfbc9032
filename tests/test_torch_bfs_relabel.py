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
``test_torch_kernels_card.py``; here its launch geometry is checked (every
node owned once, the halo covers each launch's sweeps, shared memory and
threads within the card's limits), and a plain emulation of its
shared-memory windows is stitched back to the global sweeps.
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
from repro_torch.core.kinds import get_kind
from repro_torch.core.maxflow import grid as tg
from repro_torch.core.maxflow.ref import maxflow_grid_ref
from repro_torch.core.warm import WarmStart, solve_warm
from repro_torch.kernels.bfs_relabel import kernel as tk
from repro_torch.kernels.bfs_relabel import ops as tops
from repro_torch.kernels.bfs_relabel.ref import bfs_relabel_sweeps_ref

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


# Shapes of the card tests: 1 x 1, 3 x 5, one row, one column, B = 2,
# the checkerboard's 256^2, a ragged 513 x 65, a height below every tile,
# and the smoke's 4 x 512^2.
GEOMETRY_SHAPES = [(1, 1, 1), (1, 3, 5), (1, 1, 300), (1, 300, 1),
                   (2, 200, 136), (1, 256, 256), (1, 513, 65), (1, 5, 200),
                   (4, 512, 512)]


def _owner_count(g, B, H, W):
    """How many blocks of the launch own each node: block x is instance
    x // tiles, tile x % tiles in row-major order, as the kernel has it."""
    tiles_x, tiles_y = -(-W // g.tile_w), -(-H // g.tile_h)
    count = np.zeros((B, H, W), np.int64)
    for x in range(g.blocks):
        b, t = divmod(x, tiles_x * tiles_y)
        i0, j0 = (t // tiles_x) * g.tile_h, (t % tiles_x) * g.tile_w
        count[b, i0:i0 + g.tile_h, j0:j0 + g.tile_w] += 1
    return count


def _check_geometry(g, shape, sweeps, with_ds):
    B, H, W = shape
    wh, ww = g.tile_h + 2 * g.halo, g.tile_w + 2 * g.halo
    assert (g.tile_h, g.tile_w) in tk.TILES
    assert g.launches == -(-sweeps // tk.R_MAX)
    # every launch runs at most R_MAX sweeps, and the halo carries them
    assert g.halo >= min(sweeps, tk.R_MAX) and g.halo == tk.R_MAX
    assert g.tile_w % 4 == 0
    assert g.threads == wh * ww // 4 <= tk.MAX_THREADS == 1024
    assert g.threads % 32 == 0          # whole warps: the shuffles need them
    assert g.smem_bytes == (4 if with_ds else 2) * 4 * wh * ww
    assert g.smem_bytes <= tk.SMEM_MAX == 227 * 1024
    assert np.array_equal(_owner_count(g, B, H, W), np.ones((B, H, W)))


@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
@pytest.mark.parametrize("sweeps,with_ds", [(1, True), (8, False),
                                            (20, True)])
def test_launch_geometry_owns_every_node_once(shape, sweeps, with_ds):
    g = tk.launch_geometry(*shape, sweeps, with_ds)
    _check_geometry(g, shape, sweeps, with_ds)
    for tiles in tk.TILES:     # every shape the card tests force
        _check_geometry(tk.geometry(*shape, sweeps, with_ds, *tiles), shape,
                        sweeps, with_ds)


def test_launch_geometry_fills_the_card():
    """Large batches take the largest tile; 256^2 alone takes a tile small
    enough for about one block per SM (32 x 64 tiles would give 32)."""
    big = tk.launch_geometry(4, 512, 512, tk.SWEEPS, True)
    assert (big.tile_h, big.tile_w) == tk.TILES[0]
    assert big.blocks == 512
    board = tk.launch_geometry(1, 256, 256, tk.SWEEPS, True)
    assert board.blocks >= tk.N_SM // 2
    assert tk.launch_geometry(1, 256, 256, 8, True, n_sm=8).blocks < 64


def _emulate_windows(cap, seed_t, seed_s, dt, ds, sweeps, g):
    """The kernel's decomposition in plain torch: crop each tile's window
    (INF planes and seeds, closed edges outside the grid), run the plain
    version on it, keep the tile and stitch the tiles together."""
    B, H, W = dt.shape
    r = g.halo
    Hp = -(-H // g.tile_h) * g.tile_h + 2 * r
    Wp = -(-W // g.tile_w) * g.tile_w + 2 * r

    def pad(t, fill):
        out = torch.full(t.shape[:-2] + (Hp, Wp), fill, dtype=t.dtype)
        out[..., r:r + H, r:r + W] = t
        return out

    capp = pad(cap, 0.0)
    planes = [pad(x, INF) if x is not None else None
              for x in (seed_t, seed_s, dt, ds)]
    out_t, out_s = torch.empty_like(dt), None if ds is None else (
        torch.empty_like(ds))
    for i0 in range(0, H, g.tile_h):
        for j0 in range(0, W, g.tile_w):
            win = (slice(None), slice(i0, i0 + g.tile_h + 2 * r),
                   slice(j0, j0 + g.tile_w + 2 * r))
            crop = [None if p is None else p[win].contiguous()
                    for p in planes]
            got_t, got_s, _ = bfs_relabel_sweeps_ref(
                capp[(slice(None),) + win].contiguous(), *crop,
                sweeps=sweeps)
            h, w = min(g.tile_h, H - i0), min(g.tile_w, W - j0)
            out_t[:, i0:i0 + h, j0:j0 + w] = got_t[:, r:r + h, r:r + w]
            if ds is not None:
                out_s[:, i0:i0 + h, j0:j0 + w] = got_s[:, r:r + h, r:r + w]
    return out_t, out_s


def _chained_inputs(maker, B, calls):
    """K3 inputs that are not the seeds: the planes after ``calls`` calls
    from the seeds, so wavefronts cross tile edges inside the next call."""
    probs = [maker(np.random.default_rng(40 + b)) for b in range(B)]
    cap, cs, ct = _stack(probs)
    H, W = cs.shape[-2:]
    seed_t, seed_s = _seeds(cs, ct, H * W + 2)
    cap, seed_t, seed_s = _t(cap, seed_t, seed_s)
    dt, ds = seed_t, seed_s
    for _ in range(calls):
        dt, ds, _ = tk.bfs_relabel_sweeps(cap, seed_t, seed_s, dt, ds)
    return cap, seed_t, seed_s, dt, ds


@pytest.mark.parametrize("maker,B,calls", [
    (lambda rng: random_grid_problem(rng, 40, 70), 2, 1),
    (lambda rng: long_path_problem(37, 29), 1, 2),
    (lambda rng: checkerboard_problem(48, 40), 1, 3)])
@pytest.mark.parametrize("tiles", tk.TILES)
def test_window_decomposition_stitches_to_global_sweeps(maker, B, calls,
                                                        tiles):
    """Each window of the kernel's launch, swept k <= R_MAX times on its
    own, holds the global result on its tile, for k = 1..8, with the
    source plane on and off."""
    cap, seed_t, seed_s, dt, ds = _chained_inputs(maker, B, calls)
    _, H, W = dt.shape
    g = tk.geometry(B, H, W, tk.R_MAX, True, *tiles)
    for k in range(1, tk.R_MAX + 1):
        want = bfs_relabel_sweeps_ref(cap, seed_t, seed_s, dt, ds, sweeps=k)
        got = _emulate_windows(cap, seed_t, seed_s, dt, ds, k, g)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        got_t, _ = _emulate_windows(cap, seed_t, None, dt, None, k, g)
        want_t = bfs_relabel_sweeps_ref(cap, seed_t, None, dt, None,
                                        sweeps=k)[0]
        assert torch.equal(got_t, want_t)


@pytest.mark.parametrize("calls", [0, 1, 3, 40])
@pytest.mark.parametrize("with_ds", [True, False])
def test_changed_is_any_value_moved(calls, with_ds):
    """On the plain path ``changed`` is ``any(out != in)``; 40 calls of 8
    sweeps reach the fixpoint of a 24 x 20 long path, where it is 0."""
    cap, seed_t, seed_s, dt, ds = _chained_inputs(
        lambda rng: long_path_problem(24, 20), 1, calls)
    if not with_ds:
        seed_s = ds = None
    out_t, out_s, changed = tk.bfs_relabel_sweeps(cap, seed_t, seed_s, dt,
                                                  ds)
    moved = bool((out_t != dt).any())
    if with_ds:
        moved |= bool((out_s != ds).any())
    assert changed.dtype == torch.int32 and int(changed) == int(moved)
    assert moved == (calls < 40)


@pytest.mark.parametrize("maker", [
    lambda rng: random_grid_problem(rng, 12, 20),
    lambda rng: long_path_problem(10, 10),
    lambda rng: checkerboard_problem(12, 12)])
@pytest.mark.parametrize("backend", ["xla", "balanced"])
def test_drivers_keep_heights_in_the_kernels_range(monkeypatch, maker,
                                                   backend):
    """The kernel's closed-edge weight INF - 1 makes it exact only for
    seeds and planes in [1, INF]. Every K3 call of a grid solve, through
    the sink-only ``bfs_heights`` (xla) and the bidirectional
    ``bfs_relabel_heights`` (balanced), stays in that range, on its inputs
    and on its outputs. So does every K3 call of a warm re-solve of the
    same grid with its capacities cut (``solve_warm``): the warm init's
    heights are a fresh BFS of the repaired residual graph, with a uniform
    N on the unreachable region, and its solve continues from them."""
    calls = []
    sweeps = tk._sweeps

    def spy(cap, *planes_and_sweeps):
        out = sweeps(cap, *planes_and_sweeps)
        planes = [p for p in planes_and_sweeps[:4] + out[:2] if p is not None]
        calls.append((min(int(p.min()) for p in planes),
                      max(int(p.max()) for p in planes)))
        return out

    monkeypatch.setattr(tk, "_sweeps", spy)
    cap, cs, ct = maker(np.random.default_rng(5))
    prob = tg.GridProblem(cap, cs, ct)
    res = tg.maxflow_grid(prob, backend=backend, device="cpu")
    assert calls
    assert all(1 <= lo and hi <= INF for lo, hi in calls)
    n_cold = len(calls)
    sol = get_kind("maxflow").solution_of(res)
    cut = tg.GridProblem(np.floor(cap * 0.5), cs, np.floor(ct * 0.75))
    warm = solve_warm("maxflow", [cut],
                      {0: WarmStart(sol, base_problem=prob)},
                      backend=backend, device="cpu")[0]
    assert len(calls) > n_cold
    assert all(1 <= lo and hi <= INF for lo, hi in calls[n_cold:])
    assert float(warm.flow) == maxflow_grid_ref(*cut)


def test_sweep_counter_advances_on_the_cpu_path():
    """``sweeps`` counts sweeps on both paths; ``launches`` counts kernel
    launches and so stays put on the CPU."""
    cap, seed_t, seed_s, dt, ds = _chained_inputs(
        lambda rng: random_grid_problem(rng, 8, 8), 1, 0)
    sweeps, launches = tk.bfs_relabel_sweeps.sweeps, \
        tk.bfs_relabel_sweeps.launches
    tk.bfs_relabel_sweeps(cap, seed_t, seed_s, dt, ds, sweeps=20)
    tk.bfs_relabel_sweeps(cap, seed_t, None, dt, None, sweeps=3)
    assert tk.bfs_relabel_sweeps.sweeps == sweeps + 23
    assert tk.bfs_relabel_sweeps.launches == launches
