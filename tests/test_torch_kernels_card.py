"""On the card: each CUDA kernel against its plain PyTorch version, and
each solver on the card against the same solver on the CPU.

Every test here needs a CUDA card and skips without one (marker
``torch``). The file imports no ``jax``, so it runs where only PyTorch is
installed: ``python -m pytest -q -m torch tests/test_torch_*.py``.
Tolerance: bitwise equality for K1-K5; the kernels repeat the plain
versions' integer and float32 compare/select/min arithmetic exactly. K6
sums in another order than its plain version (a dense float32 softmax), so
it is held to the JAX package's kernel-test bounds: max abs error 3e-5 in
float32 and 2e-2 in bfloat16.
"""
import numpy as np
import pytest
import torch
from torch_parity import assert_same, bits_equal, cuda_device  # noqa: F401

from repro_torch.configs.base import get_config, smoke_variant
from repro_torch.core.assignment.cost_scaling import solve_assignment
from repro_torch.core.matching import match_bipartite_batch
from repro_torch.core.matching.ref import random_bipartite
from repro_torch.core.maxflow.grid import (INF_H, GridProblem,
                                           maxflow_grid_batch)
from repro_torch.core.maxflow.ref import (checkerboard_problem,
                                          long_path_problem,
                                          random_grid_problem)
from repro_torch.kernels.bfs_relabel import kernel as bk
from repro_torch.kernels.bfs_relabel.ref import bfs_relabel_sweeps_ref
from repro_torch.kernels.bidding import kernel as bidk
from repro_torch.kernels.bidding.ref import INF, bidding_ref
from repro_torch.interop import model_from_params, numpy_params
from repro_torch.kernels.flash_attention import kernel as fak
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.frontier import kernel as frk
from repro_torch.kernels.frontier.ref import frontier_ref
from repro_torch.kernels.grid_push import kernel as gk
from repro_torch.kernels.grid_push.ops import tile_schedule, tile_shape
from repro_torch.kernels.grid_push.ref import (grid_push_decide_ref,
                                               grid_push_decide_sched_ref)
from repro_torch.models.model import apply_model
from repro_torch.serve.engine import greedy_generate

pytestmark = pytest.mark.torch


def _stack(probs):
    return (np.stack([p[0] for p in probs], axis=1),
            np.stack([p[1] for p in probs]), np.stack([p[2] for p in probs]))


def _inputs(dev, B=2, H=192, W=160, seed=0):
    """Random decision inputs: integer caps with zeros, half the nodes
    active, heights over [0, 2N) with a few INF."""
    rng = np.random.default_rng(seed)
    cap, cs, ct = _stack([random_grid_problem(rng, H, W) for _ in range(B)])
    n = H * W + 2
    e = rng.integers(0, 9, (B, H, W)) * (rng.random((B, H, W)) < 0.5)
    h = rng.integers(0, 2 * n, (B, H, W))
    h[0, 0, :5] = INF_H
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=dev)  # noqa: E731
    return (t(e, torch.float32), t(h, torch.int32), t(cap, torch.float32),
            t(cs, torch.float32), t(ct, torch.float32), n)


def test_k1_kernel_equals_plain(cuda_device):
    args = _inputs(cuda_device)
    before = gk.grid_push_decide.launches
    got = gk.grid_push_decide(*args)
    torch.cuda.synchronize()
    assert gk.grid_push_decide.launches == before + 1
    want = grid_push_decide_ref(*args)
    assert all(bits_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("B,H,W", [(4, 512, 512), (1, 256, 256),
                                   (2, 256, 200), (2, 100, 128)])
@pytest.mark.parametrize("active", ["some", "none", "all"])
def test_k2_kernel_equals_plain(cuda_device, B, H, W, active):
    """K2 against its plain version and against K1, with idle tiles, with
    no tile active and with every tile active."""
    e, h, cap, cs, ct, n = _inputs(cuda_device, B=B, H=H, W=W)
    if active == "some":
        e[:, :64] = 0                  # idle tiles
    elif active == "none":
        e.zero_()
    else:
        e[:, ::16, ::16] = 1.0         # a node with excess in every tile
    bh, bw = tile_shape(H, W)
    sched, nact = tile_schedule(e > 0, bh, bw)
    T = (H // bh) * (W // bw)
    if active != "some":
        assert nact.tolist() == [0 if active == "none" else T] * B
    args = (e, h, cap, cs, ct, sched, nact, n)
    before = gk.grid_push_decide_sched.launches
    got = gk.grid_push_decide_sched(*args, block_h=bh, block_w=bw)
    torch.cuda.synchronize()
    assert gk.grid_push_decide_sched.launches == before + 1
    want = grid_push_decide_sched_ref(*args, bh, bw)
    assert all(bits_equal(g, w) for g, w in zip(got, want))
    k1 = gk.grid_push_decide(e, h, cap, cs, ct, n)
    assert all(bits_equal(g, w) for g, w in zip(got, k1))


# K3 shapes (B, H, W): 1 x 1, 3 x 5, one row, one column, B = 2, the
# checkerboard's 256^2 alone, a ragged 513 x 65, a height below every tile
K3_SHAPES = [(1, 1, 1), (1, 3, 5), (1, 1, 300), (1, 300, 1), (2, 200, 136),
             (1, 256, 256), (1, 513, 65), (1, 5, 200)]


def _k3_inputs(dev, B, H, W, maker=random_grid_problem, calls=0):
    """(cap, seed_t, seed_s, dt, ds) on ``dev``: the planes after ``calls``
    plain calls of 8 sweeps from the seeds, so that wavefronts cross tile
    edges inside the next call."""
    rng = np.random.default_rng(1)
    if maker is random_grid_problem:
        probs = [random_grid_problem(rng, H, W) for _ in range(B)]
    else:
        probs = [maker(H, W) for _ in range(B)]
    cap, cs, ct = _stack(probs)
    n = H * W + 2
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    cap = t(cap)
    seed_t = t(np.where(ct > 0, 1, INF_H).astype(np.int32))
    seed_s = t(np.where(cs > 0, n + 1, INF_H).astype(np.int32))
    dt, ds = seed_t, seed_s
    for _ in range(calls):
        dt, ds, _ = bfs_relabel_sweeps_ref(cap, seed_t, seed_s, dt, ds,
                                           sweeps=bk.SWEEPS)
    return cap, seed_t, seed_s, dt, ds


def _k3_check(args, sweeps, tiles=None):
    """One K3 call against the plain version, bitwise, with its counters:
    one launch per chunk of up to R_MAX sweeps, every sweep counted. With
    ``tiles`` the launch takes that tile shape instead of
    ``launch_geometry``'s."""
    launches = bk.bfs_relabel_sweeps.launches
    swept = bk.bfs_relabel_sweeps.sweeps
    got = bk._sweeps(*args, sweeps, tiles)
    torch.cuda.synchronize()
    assert bk.bfs_relabel_sweeps.launches == launches + -(-sweeps
                                                          // bk.R_MAX)
    assert bk.bfs_relabel_sweeps.sweeps == swept + sweeps
    want = bfs_relabel_sweeps_ref(*args, sweeps=sweeps)
    for g, w in zip(got, want):
        assert (g is None and w is None) or bits_equal(g, w)


@pytest.mark.parametrize("shape", K3_SHAPES)
@pytest.mark.parametrize("sweeps", [1, 2, 3, 7, 8, 20])
@pytest.mark.parametrize("with_ds", [True, False])
def test_k3_kernel_equals_plain(cuda_device, shape, sweeps, with_ds):
    cap, seed_t, seed_s, dt, ds = _k3_inputs(cuda_device, *shape)
    if not with_ds:
        seed_s = ds = None
    _k3_check((cap, seed_t, seed_s, dt, ds), sweeps)


@pytest.mark.parametrize("tiles", bk.TILES)
@pytest.mark.parametrize("maker,shape,calls", [
    (random_grid_problem, (2, 200, 136), 2),
    (long_path_problem, (1, 256, 256), 5),
    (checkerboard_problem, (1, 256, 256), 3),
    (random_grid_problem, (1, 513, 65), 1)])
def test_k3_chained_inputs_every_tile_shape(cuda_device, tiles, maker, shape,
                                            calls):
    """Mid-fixpoint planes (not the seeds), under every tile shape the
    kernel is launched with, for 8 and 20 sweeps, with ds on and off."""
    cap, seed_t, seed_s, dt, ds = _k3_inputs(cuda_device, *shape,
                                             maker=maker, calls=calls)
    for sweeps in (8, 20):
        _k3_check((cap, seed_t, seed_s, dt, ds), sweeps, tiles)
        _k3_check((cap, seed_t, None, dt, None), sweeps, tiles)


@pytest.mark.parametrize("field,delta", [("threads", -32),
                                         ("smem_bytes", 4)])
def test_k3_refuses_a_geometry_it_would_not_launch_as_given(
        cuda_device, monkeypatch, field, delta):
    """The C entry launches with the threads and shared memory of
    ``geometry`` and refuses values that do not fit the tile."""
    cap, seed_t, seed_s, dt, ds = _k3_inputs(cuda_device, 1, 64, 64)
    geometry = bk.geometry
    monkeypatch.setattr(bk, "geometry", lambda *a: geometry(*a)._replace(
        **{field: getattr(geometry(*a), field) + delta}))
    with pytest.raises(RuntimeError, match="bfs_relabel_sweeps"):
        bk._sweeps(cap, seed_t, seed_s, dt, ds, bk.SWEEPS, bk.TILES[0])


def test_k3_changed_flag(cuda_device):
    """A call at the fixpoint reports 0; a call whose only move is one cell
    next to a tile edge (raised by one above its fixpoint) reports 1."""
    B, H, W = 1, 256, 256
    cap, seed_t, seed_s, dt, ds = _k3_inputs(cuda_device, B, H, W)
    changed = True
    while changed:
        dt, ds, flag = bfs_relabel_sweeps_ref(cap, seed_t, seed_s, dt, ds,
                                              sweeps=bk.SWEEPS)
        changed = bool(flag)
    _, _, flag = bk.bfs_relabel_sweeps(cap, seed_t, seed_s, dt, ds)
    assert int(flag) == 0
    g = bk.launch_geometry(B, H, W, bk.SWEEPS, True)
    i = g.tile_h                       # the first row of the next tile row
    j = int(torch.nonzero(dt[0, i] < INF_H)[0])
    bumped = dt.clone()
    bumped[0, i, j] += 1
    got_t, got_s, flag = bk.bfs_relabel_sweeps(cap, seed_t, seed_s, bumped,
                                               ds)
    assert int(flag) == 1
    assert bits_equal(got_t, dt) and bits_equal(got_s, ds)


@pytest.mark.parametrize("backend", ["xla", "multipush", "pallas",
                                     "balanced"])
def test_slice_on_card_equals_cpu(cuda_device, backend):
    rng = np.random.default_rng(2)
    probs = [random_grid_problem(rng, 64, 64) for _ in range(2)]
    probs.append(checkerboard_problem(64, 64))
    prob = GridProblem(*(np.stack([p[k] for p in probs]) for k in range(3)))
    got = maxflow_grid_batch(prob, backend=backend, device=cuda_device)
    want = maxflow_grid_batch(prob, backend=backend, device="cpu")
    assert_same(got, want)
    assert bool(got.converged.all())


# (shape, ties): the smoke's 8 x 512^2, one instance, wide rows (4096
# and 2048 columns), n_c % 16 != 0 and n_c % 4 != 0 (the scalar path),
# blocks across instances (2 x 40 x 1000, 64 rows of one column, 5 x 101
# x 512), a last block with 1 row of its 8 (5 x 101 = 505 rows) and the
# first design's shapes
K4_SHAPES = [((8, 512, 512), False), ((1, 512, 512), True),
             ((2, 300, 4096), False), ((2, 2048, 2048), True),
             ((3, 96, 516), True), ((2, 40, 1000), True), ((64, 1), True),
             ((5, 101, 512), True), ((3, 96, 512), False),
             ((2, 40, 37), True)]


def _k4_inputs(dev, shape, ties, seed=3, store=None):
    """K4 inputs: costs in 0..3 (ties) or the solver's scaled weights,
    prices in -3..2, 30% of the arcs and every 7th row masked; the mask
    into ``store`` when given."""
    rng = np.random.default_rng(seed)
    *batch, n_r, n_c = shape
    c = (rng.integers(0, 4, shape) if ties
         else -(n_c + 1) * rng.integers(0, 101, shape))
    p = rng.integers(-3, 3, tuple(batch) + (n_c,))
    mask = rng.random(shape) < 0.3
    mask[..., ::7, :] = True
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=dev)  # noqa
    m = t(mask, torch.bool)
    if store is not None:
        store.copy_(m)
        m = store
    return t(c, torch.int32), t(p, torch.int32), m


def _k4_check(args, geometry=None):
    """One launch, the plain version's bits, masked rows (INF, 0, INF)."""
    before = bidk.bidding.launches
    got = bidk._bidding(*args, geometry)
    torch.cuda.synchronize()
    assert bidk.bidding.launches == before + 1
    want = bidding_ref(*args)
    assert all(bits_equal(g, w) for g, w in zip(got, want))
    assert bool((got[1][..., ::7] == 0).all())
    assert bool((got[0][..., ::7] == INF).all())
    return got


@pytest.mark.parametrize("shape,ties", K4_SHAPES)
def test_k4_kernel_equals_plain(cuda_device, shape, ties):
    """Every shape of the vector and scalar paths, ties, masked rows."""
    _k4_check(_k4_inputs(cuda_device, shape, ties))


def _k4_geometry(args, aligned=True):
    *batch, n_r, n_c = args[0].shape
    return bidk.launch_geometry(int(np.prod(batch)), n_r, n_c, aligned)


@pytest.mark.parametrize("shape", [(3, 96, 512), (8, 512, 512)])
def test_k4_each_path_gives_the_same_bits(cuda_device, shape):
    """The vector path, as ``launch_geometry`` takes it, and the scalar
    path forced at the same shape: the same bits."""
    args = _k4_inputs(cuda_device, shape, True)
    vector, scalar = _k4_geometry(args), _k4_geometry(args, aligned=False)
    assert vector.vec and not scalar.vec
    got = [_k4_check(args, g) for g in (vector, scalar)]
    assert all(bits_equal(a, b) for a, b in zip(*got))


def test_k4_unaligned_mask_takes_the_scalar_path(cuda_device):
    """A contiguous mask 1 byte past a 4-byte boundary, at a width the
    vector path would take: the scalar path, the same bits."""
    shape = (2, 96, 512)
    store = torch.empty(int(np.prod(shape)) + 1, dtype=torch.bool,
                        device=cuda_device)[1:].view(shape)
    args = _k4_inputs(cuda_device, shape, True, store=store)
    assert args[2].is_contiguous() and args[2].data_ptr() % 4 != 0
    _k4_check(args)


@pytest.mark.parametrize("field,delta", [
    ("threads", -32), ("rows_per_block", -1), ("blocks", 1),
    ("blocks", -1), ("vec", 1)])
def test_k4_refuses_a_geometry_that_does_not_fit(cuda_device, monkeypatch,
                                                 field, delta):
    """The C entry launches with ``launch_geometry``'s values as given and
    refuses those that do not fit the build or the shapes: a launch that
    would miss a row or hold a block without one is never made."""
    args = _k4_inputs(cuda_device, (8, 512, 512), False)
    geometry = bidk.launch_geometry

    def bent(*a):
        g = geometry(*a)
        return g._replace(**{field: getattr(g, field) + delta})
    monkeypatch.setattr(bidk, "launch_geometry", bent)
    before = bidk.bidding.launches
    with pytest.raises(RuntimeError, match="bidding"):
        bidk.bidding(*args)
    assert bidk.bidding.launches == before


def test_k4_refuses_the_vector_path_where_rows_are_not_4_columns(
        cuda_device):
    """n_c % 4 != 0 with the vector path forced on it: refused."""
    args = _k4_inputs(cuda_device, (2, 40, 37), True)
    forced = _k4_geometry(args)._replace(vec=1)
    before = bidk.bidding.launches
    with pytest.raises(RuntimeError, match="bidding"):
        bidk._bidding(*args, forced)
    assert bidk.bidding.launches == before


# (shape, share of rows labeled, roots): the 16-column and scalar (n_c =
# 37) paths, one row, one row past a cluster's span (launch_geometry
# takes clusters of 16 at that shape), many chunks per
# block, the smoke's shape nearly empty and full, no labeled row, and one
# root for every labeled row (ties decided by the row across the blocks
# of a cluster)
K5_CASES = [((2, 600, 1024), 0.5, "few"), ((3, 257, 48), 0.5, "few"),
            ((1, 300, 37), 0.5, "few"), ((1, 1, 16), 1.0, "few"),
            ((2, frk.CLUSTER_MAX * frk.CHUNK + 1, 512), 0.5, "few"),
            ((1, 5000, 512), 0.5, "many"), ((4, 4096, 4096), 0.02, "many"),
            ((4, 4096, 4096), 1.0, "many"), ((2, 600, 1024), 0.0, "few"),
            ((2, 3000, 512), 1.0, "same"), ((2, 3000, 37), 0.7, "same")]


def _k5_inputs(dev, shape, share=0.5, roots="few", seed=4, adj=None):
    """K5 inputs: adjacency at 5% density (into ``adj`` when given),
    ``share`` of the rows labeled with roots from [0, 5) (``few``), from
    the rows (``many``) or all 7 (``same``), random matched columns."""
    rng = np.random.default_rng(seed)
    *batch, n_r, n_c = shape
    rows = tuple(batch) + (n_r,)
    r = {"few": rng.integers(0, 5, rows), "many": rng.integers(0, n_r, rows),
         "same": np.full(rows, 7)}[roots]
    root = np.where(rng.random(rows) < share, r, INF)
    match = rng.integers(-1, n_c, rows)
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=dev)  # noqa
    a = t(rng.random(shape) < 0.05, torch.bool)
    if adj is not None:
        adj.copy_(a)
        a = adj
    return a, t(root, torch.int32), t(match, torch.int32)


def _k5_check(args, geometry=None):
    before = frk.frontier.launches
    got = frk._frontier(*args, geometry)
    torch.cuda.synchronize()
    assert frk.frontier.launches == before + 1
    want = frontier_ref(*args)
    assert all(bits_equal(g, w) for g, w in zip(got, want))
    return got


@pytest.mark.parametrize("shape,share,roots", K5_CASES)
def test_k5_kernel_equals_plain(cuda_device, shape, share, roots):
    got = _k5_check(_k5_inputs(cuda_device, shape, share, roots))
    if share == 0.0:
        assert bool((got[0] == INF).all()) and bool((got[1] == 0).all())


@pytest.mark.parametrize("cluster", [1, 2, frk.CLUSTER, frk.CLUSTER_MAX])
@pytest.mark.parametrize("shape", [(2, 600, 1024), (1, 300, 37),
                                   (4, 4096, 4096)])
def test_k5_every_cluster_size(cuda_device, shape, cluster):
    """Every cluster size, whichever ``launch_geometry`` would take, 16
    included (the non-portable maximum): the same bits."""
    args = _k5_inputs(cuda_device, shape, 0.5, "same")
    *batch, n_r, n_c = shape
    g = frk.launch_geometry(int(np.prod(batch)), n_r, n_c, n_c % 16 == 0,
                            cluster)
    _k5_check(args, g)


def test_k5_smoke_shape_runs_in_one_wave(cuda_device):
    """The card holds every cluster of the smoke's 4 x 4096^2 launch at
    once (a second wave would add a whole pass of the fixed cost)."""
    g = frk.launch_geometry(4, 4096, 4096, True)
    assert frk.max_active_clusters(g) >= g.grid[0] * g.grid[1] // g.cluster


@pytest.mark.parametrize("shape", [(1, 4096, 4096), (2, 4096, 4096),
                                   (1, 20000, 512), (1, 300, 37)])
def test_k5_clusters_of_16_run_in_one_wave(cuda_device, shape):
    """Where ``launch_geometry`` takes clusters of 16 (grids that clusters
    of 8 would leave SMs idle in), the card holds all of them at once, and
    the kernel computes the same bits."""
    B, n_r, n_c = shape
    g = frk.launch_geometry(B, n_r, n_c, n_c % 16 == 0)
    assert g.cluster == frk.CLUSTER_MAX
    assert frk.max_active_clusters(g) >= g.grid[0] * g.grid[1] // g.cluster
    _k5_check(_k5_inputs(cuda_device, shape))


def test_k5_unaligned_adjacency_takes_the_scalar_path(cuda_device):
    """A contiguous adjacency 1 byte past a 16-byte boundary, at a width
    the vector path would take: the scalar path, the same bits."""
    shape = (2, 600, 512)
    store = torch.empty(int(np.prod(shape)) + 1, dtype=torch.bool,
                        device=cuda_device)
    adj = store[1:].view(shape)
    assert adj.is_contiguous() and adj.data_ptr() % 16 != 0
    _k5_check(_k5_inputs(cuda_device, shape, adj=adj))


@pytest.mark.parametrize("field,delta", [
    ("threads", -32), ("smem_bytes", 8), ("rows_per_block", -1),
    ("cluster", frk.CLUSTER_MAX + 1 - frk.CLUSTER), ("grid", 1),
    ("vec", -15)])
def test_k5_refuses_a_geometry_that_does_not_fit(cuda_device, monkeypatch,
                                                 field, delta):
    """The C entry launches with ``launch_geometry``'s values as given and
    refuses those that do not fit the build, the shapes or the card."""
    args = _k5_inputs(cuda_device, (1, 600, 1024))
    geometry = frk.launch_geometry

    def bent(*a):
        g = geometry(*a)
        if field == "grid":
            return g._replace(grid=(g.grid[0] + delta, g.grid[1]))
        return g._replace(**{field: getattr(g, field) + delta})
    monkeypatch.setattr(frk, "launch_geometry", bent)
    before = frk.frontier.launches
    with pytest.raises(RuntimeError, match="frontier"):
        frk.frontier(*args)
    assert frk.frontier.launches == before


@pytest.mark.parametrize("method", ["auction", "pushrelabel"])
def test_assignment_on_card_equals_cpu(cuda_device, method):
    w = np.random.default_rng(5).integers(0, 101, size=(3, 48, 48))
    before = bidk.bidding.launches
    got = solve_assignment(w, method=method, backend="pallas",
                           device=cuda_device)
    assert bidk.bidding.launches > before
    want = solve_assignment(w, method=method, backend="pallas", device="cpu")
    assert_same(got, want)
    assert bool(got.converged.all())


def test_matching_on_card_equals_cpu(cuda_device):
    rng = np.random.default_rng(6)
    adj = np.stack([random_bipartite(rng, 300, 200, 4 / 200)
                    for _ in range(3)])
    before = frk.frontier.launches
    got = match_bipartite_batch(adj, backend="pallas", device=cuda_device)
    assert frk.frontier.launches > before
    want = match_bipartite_batch(adj, backend="pallas", device="cpu")
    assert_same(got, want)
    assert bool(got.converged.all())


# (B, Sq, Sk, H, KV, dh, dv), causal: the JAX kernel test's five shapes,
# ragged lengths (tails of both tiles), Sq != Sk, and the widths of the
# later MLA slice (dh 192, dv 128) and the limit (256)
K6_SWEEP = [
    ((2, 64, 64, 4, 2, 16, 16), True),
    ((1, 128, 128, 6, 3, 32, 16), False),
    ((2, 256, 256, 8, 8, 64, 64), True),
    ((1, 64, 64, 4, 1, 16, 8), True),
    ((1, 512, 512, 2, 2, 32, 32), True),
    ((2, 100, 100, 9, 3, 64, 64), True),
    ((1, 70, 130, 4, 2, 24, 40), False),
    ((1, 130, 70, 4, 2, 24, 40), True),
    ((1, 96, 96, 4, 4, 192, 128), True),
    ((1, 65, 65, 2, 1, 256, 256), True),
    # off the 64-row query and 64/32-key tiles, Sq != Sk both ways, MQA,
    # every head-width class (dh 8 / 24 / 72 / 192 / 256; q in registers up
    # to 64), odd widths (4-byte copies)
    ((1, 1000, 1000, 4, 2, 64, 64), True),
    ((1, 100, 1000, 4, 1, 64, 64), False),
    ((1, 1000, 100, 4, 2, 64, 64), True),
    ((2, 77, 77, 4, 2, 8, 8), True),
    ((1, 100, 100, 4, 2, 24, 24), False),
    ((1, 100, 100, 4, 2, 72, 72), True),
    ((1, 100, 1000, 3, 1, 72, 24), False),
    ((1, 129, 129, 4, 2, 192, 128), False),
    ((1, 100, 100, 2, 2, 256, 256), False),
    ((1, 33, 47, 2, 1, 5, 3), True),
]


@pytest.mark.parametrize("dims,causal", K6_SWEEP)
def test_k6_kernel_close_to_plain(cuda_device, dims, causal):
    B, Sq, Sk, H, KV, dh, dv = dims
    rng = np.random.default_rng(7)
    t = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32),  # noqa
                                device=cuda_device)
    q, k, v = t(B, Sq, H, dh), t(B, Sk, KV, dh), t(B, Sk, KV, dv)
    before = fak.flash_attention_fwd.launches
    got = fak.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fak.flash_attention_fwd.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max().item() <= 3e-5


# bfloat16: the JAX kernel test's case, the serve prefill's shape, tails
# with MQA and dh != dv, the widest heads, odd dh (synchronous 2-byte copies)
K6_BF16 = [
    ((2, 64, 64, 4, 2, 16, 16), True),
    ((8, 1024, 1024, 9, 3, 64, 64), True),
    ((1, 100, 1000, 4, 1, 72, 40), False),
    ((1, 1000, 100, 4, 2, 24, 24), True),
    ((1, 65, 65, 2, 1, 256, 256), True),
    ((1, 50, 50, 2, 1, 7, 9), True),
]


@pytest.mark.parametrize("dims,causal", K6_BF16)
def test_k6_kernel_bf16_close_to_plain(cuda_device, dims, causal):
    B, Sq, Sk, H, KV, dh, dv = dims
    rng = np.random.default_rng(1)
    t = lambda *s: torch.tensor(rng.normal(size=s), dtype=torch.bfloat16,  # noqa
                                device=cuda_device)
    q, k, v = t(B, Sq, H, dh), t(B, Sk, KV, dh), t(B, Sk, KV, dv)
    got = fak.flash_attention_fwd(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_kernel_reads_unaligned_inputs(cuda_device, dtype):
    """Contiguous views 4 (bf16: 2) bytes past a 16-byte boundary: the
    kernel copies with 4-byte (bf16: 2-byte) chunks and stores o as is."""
    rng = np.random.default_rng(3)

    def view(*s):
        flat = torch.tensor(rng.normal(size=int(np.prod(s)) + 1),
                            dtype=dtype, device=cuda_device)
        return flat[1:].view(s)
    q, k, v = view(1, 100, 4, 64), view(1, 100, 2, 64), view(1, 100, 2, 64)
    assert q.data_ptr() % 16 != 0
    got = fak.flash_attention_fwd(q, k, v, causal=True)
    want = flash_attention_ref(q, k, v, causal=True)
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dims,dtype,field,delta", [
    ((1, 100, 4, 64, 64), torch.float32, "smem_bytes", 16),   # wgmma
    ((1, 100, 4, 64, 64), torch.float32, "k_stride", 4),
    ((1, 100, 4, 64, 64), torch.bfloat16, "block_k", -32),   # mma.sync
    ((1, 100, 4, 72, 72), torch.float32, "dh_pad", -16),
    ((1, 100, 4, 72, 72), torch.float32, "v_stride", 4),
    ((1, 100, 4, 256, 256), torch.float32, "dv_class", -128),
])
def test_k6_refuses_a_geometry_that_does_not_fit(
        cuda_device, monkeypatch, dims, dtype, field, delta):
    """The C entry launches with ``launch_geometry``'s values as given and
    refuses those that do not fit the kernel they pick."""
    B, S, H, dh, dv = dims
    q = torch.zeros(B, S, H, dh, dtype=dtype, device=cuda_device)
    k = torch.zeros(B, S, 2, dh, dtype=dtype, device=cuda_device)
    v = torch.zeros(B, S, 2, dv, dtype=dtype, device=cuda_device)
    geometry = fak.launch_geometry
    monkeypatch.setattr(fak, "launch_geometry", lambda *a: geometry(
        *a)._replace(**{field: getattr(geometry(*a), field) + delta}))
    with pytest.raises(RuntimeError, match="flash_attention_fwd"):
        fak.flash_attention_fwd(q, k, v, causal=True)


def test_k6_refuses_autograd(cuda_device):
    q = torch.zeros(1, 8, 2, 16, device=cuda_device, requires_grad=True)
    k = torch.zeros(1, 8, 1, 16, device=cuda_device)
    with pytest.raises(NotImplementedError, match="backward"):
        fak.flash_attention_fwd(q, k, k)


def test_serve_on_card_close_to_cpu(cuda_device):
    """smollm-135m at smoke size: prefill logits and greedy tokens on the
    card against the CPU path (plain scan); K6 launched once per layer of
    the prefill. Tolerance 1e-4 x the largest |logit|: float32 on both
    sides, summed in other orders."""
    cfg = smoke_variant(get_config("smollm-135m"))
    params = numpy_params(cfg, seed=0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    outs = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = model_from_params(cfg, params, device=dev)
        tok = torch.tensor(toks, dtype=torch.int32, device=dev)
        before = fak.flash_attention_fwd.launches
        with torch.no_grad(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            logits = apply_model(model, {"tokens": tok}).logits
            if dev.type == "cuda":
                torch.cuda.synchronize()
        launched = fak.flash_attention_fwd.launches - before
        assert launched == (cfg.n_layers if dev.type == "cuda" else 0)
        if dev.type == "cuda":   # every launch on the wgmma kernel
            k6 = [e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and "flash_fwd" in e.name]
            assert len(k6) == cfg.n_layers
            assert all("flash_fwd_wgmma" in name for name in k6), k6
        outs[dev.type] = (logits.cpu(), greedy_generate(model, tok, 6).cpu())
    (a, ta), (b, tb) = outs["cuda"], outs["cpu"]
    assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()
    assert torch.equal(ta, tb)
