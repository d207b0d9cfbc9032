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
import chip_smoke
import numpy as np
import pytest
import torch
from torch_parity import assert_same, bits_equal, cuda_device  # noqa: F401

from repro_torch.configs.base import get_config, smoke_variant
from repro_torch.core.assignment.cost_scaling import solve_assignment
from repro_torch.core.assignment.ref import optimal_weight
from repro_torch.core.batch import solve_batch
from repro_torch.core.kinds import get_kind
from repro_torch.core.matching import match_bipartite_batch
from repro_torch.core.matching.ref import hopcroft_karp, random_bipartite
from repro_torch.core.maxflow.grid import (INF_H, GridProblem,
                                           maxflow_grid_batch)
from repro_torch.core.routing import auction_route, exact_route, topk_route
from repro_torch.core.maxflow.ref import (checkerboard_problem,
                                          long_path_problem,
                                          maxflow_grid_ref,
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
from repro_torch.models.attention import MLA, KVCache, init_mla
from repro_torch.models.model import apply_model, layer_plan
from repro_torch.serve.engine import greedy_generate

pytestmark = pytest.mark.torch
# K6's log-sum-exp: the smoke's sweep and tails (shapes and dtypes)
FLASH_CASES = chip_smoke.FLASH_SWEEP + chip_smoke.FLASH_TAILS


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


# Early-exit compaction on the card: the compacted solve launches every
# kernel of its path at sub-batches of 1, 2, 4 ... instances and must give
# the masked solve's bits; the padded shapes below take the kernels' other
# paths (K2 whole-axis tiles, K4 scalar, K5 one column a load).


def _require_same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same(g, w)


def _recording(monkeypatch, module, seen):
    """Record the ``vec`` of every launch geometry ``module`` picks."""
    geometry = module.launch_geometry

    def recorded(*a, **kw):
        g = geometry(*a, **kw)
        seen.add(g.vec)
        return g
    monkeypatch.setattr(module, "launch_geometry", recorded)


@pytest.mark.parametrize("backend", ["pallas", "balanced"])
def test_compact_maxflow_on_card_equals_masked(cuda_device, backend):
    """A ragged queue padded to 96 x 80, where 64 divides neither side:
    K2's tiles are the whole grid. Compacted == masked on the card ==
    compacted on the CPU; flows are the oracle's."""
    rng = np.random.default_rng(11)
    probs = []
    for i, (h, w) in enumerate([(96, 80), (40, 64), (96, 72), (64, 80),
                                (96, 80)]):
        cap, cs, ct = random_grid_problem(rng, h, w)
        if i % 2:
            cs = np.minimum(cs, 1.0)
        probs.append(GridProblem(cap, cs, ct))
    assert tile_shape(96, 80) == (96, 80)
    kw = dict(bucket="max", backend=backend, rounds_per_heuristic=8)
    before = {f: f.launches for f in (gk.grid_push_decide,
                                      gk.grid_push_decide_sched,
                                      bk.bfs_relabel_sweeps)}
    stats = []
    got = solve_batch("maxflow", probs, compact=True, device=cuda_device,
                      stats_out=stats, **kw)
    launched = {f.__name__ for f, n in before.items() if f.launches > n}
    assert launched == ({"grid_push_decide", "bfs_relabel_sweeps"}
                        if backend == "pallas" else
                        {"grid_push_decide_sched", "bfs_relabel_sweeps"})
    assert stats[0].spread > 0, "queue not ragged"
    _require_same_results(got, solve_batch("maxflow", probs,
                                           device=cuda_device, **kw))
    _require_same_results(got, solve_batch("maxflow", probs, compact=True,
                                           device="cpu", **kw))
    assert [float(r.flow) for r in got] == [maxflow_grid_ref(*p)
                                            for p in probs]


def test_compact_assignment_on_card_equals_masked(cuda_device, monkeypatch):
    """n = 509 in an exact bucket: K4 on its scalar path (509 % 4 != 0),
    at sub-batches of 2 and 1; the 256 bucket on its vector path."""
    rng = np.random.default_rng(12)
    ws = [rng.integers(0, 101, (n, n)) for n in (509, 256, 509)]
    ws[2] //= 9                        # a shorter ε schedule
    seen = set()
    _recording(monkeypatch, bidk, seen)
    kw = dict(bucket="exact", backend="pallas", method="auction")
    got = solve_batch("assignment", ws, compact=True, device=cuda_device,
                      **kw)
    assert seen == {0, 1}, f"K4 paths {seen}: want scalar and vector"
    assert int(got[0].rounds) != int(got[2].rounds), "bucket not ragged"
    _require_same_results(got, solve_batch("assignment", ws,
                                           device=cuda_device, **kw))
    assert [int(r.weight) for r in got] == [optimal_weight(w) for w in ws]


def test_compact_matching_on_card_equals_masked(cuda_device, monkeypatch):
    """300 x 200 graphs: 200 % 16 != 0, so K5 reads one column a load."""
    rng = np.random.default_rng(13)
    adjs = [random_bipartite(rng, 300, 200, p)
            for p in (4 / 200, 2 / 200, 8 / 200, 1 / 200)]
    seen = set()
    _recording(monkeypatch, frk, seen)
    kw = dict(bucket="max", backend="pallas", greedy_init=False)
    stats = []
    got = solve_batch("matching", adjs, compact=True, device=cuda_device,
                      stats_out=stats, **kw)
    assert seen == {1}, f"K5 vec {seen}: want the one-column path"
    assert stats[0].spread > 0, "queue not ragged"
    _require_same_results(got, solve_batch("matching", adjs,
                                           device=cuda_device, **kw))
    _require_same_results(got, solve_batch("matching", adjs, compact=True,
                                           device="cpu", **kw))
    assert [int(r.cardinality) for r in got] == [hopcroft_karp(a)[2]
                                                 for a in adjs]


# Warm starts and device lanes on the card (ROADMAP M6, M7): a warm
# re-solve of a mutated batch launches the path's kernels from the warm
# state and must give the CPU's bits; lanes on the one card must give the
# solve without lanes.


def _warm_cases(kind, seed):
    """(bases, mutated) ragged instances of ``kind`` and the solver knobs
    that take its kernel path."""
    rng = np.random.default_rng(seed)
    if kind == "maxflow":
        bases = [GridProblem(*random_grid_problem(rng, h, w))
                 for h, w in [(96, 80), (64, 80), (96, 72)]]
        mutated = [GridProblem(np.floor(p.cap_nbr * rng.uniform(
            0.5, 1.5, p.cap_nbr.shape)).astype(np.float32), p.cap_src,
            p.cap_sink) for p in bases]
        return bases, mutated
    if kind == "assignment":
        bases = [rng.integers(0, 101, (n, n)) for n in (256, 200, 256)]
        mutated = [np.clip(w + rng.integers(-3, 4, w.shape)
                           * (rng.random(w.shape) < 0.01), 0, 100)
                   for w in bases]
        return bases, mutated
    bases = [random_bipartite(rng, 300, 200, p)
             for p in (4 / 200, 2 / 200, 8 / 200)]
    mutated = [a ^ (rng.random(a.shape) < 0.002) for a in bases]
    return bases, mutated


WARM_PATHS = [("maxflow", dict(backend="pallas", rounds_per_heuristic=8),
               ("grid_push_decide", "bfs_relabel_sweeps")),
              ("maxflow", dict(backend="balanced", rounds_per_heuristic=8),
               ("grid_push_decide_sched", "bfs_relabel_sweeps")),
              ("assignment", dict(backend="pallas", method="auction"),
               ("bidding",)),
              ("assignment", dict(backend="pallas", method="pushrelabel"),
               ("bidding",)),
              ("matching", dict(backend="pallas"), ("frontier",))]
_WRAPPERS = {"grid_push_decide": gk.grid_push_decide,
             "grid_push_decide_sched": gk.grid_push_decide_sched,
             "bfs_relabel_sweeps": bk.bfs_relabel_sweeps,
             "bidding": bidk.bidding, "frontier": frk.frontier}


@pytest.mark.parametrize("kind,kw,kernels", WARM_PATHS,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_warm_on_card_equals_cpu(cuda_device, kind, kw, kernels):
    """Every instance warm from its base's solution, masked and
    compacted: the card's results equal the CPU's leaf for leaf, the
    oracle's optimum, and the path's kernels launch."""
    from repro_torch.core.warm import WarmStart, solve_warm
    bases, mutated = _warm_cases(kind, 21)
    k = get_kind(kind)
    sols = {dev: [k.solution_of(r) for r in solve_batch(
        kind, bases, device=dev, **kw)] for dev in (cuda_device, "cpu")}
    want = None
    for dev in ("cpu", cuda_device):
        warm = {i: WarmStart(sols[dev][i], base_problem=bases[i])
                for i in range(len(bases))}
        for compact in (False, True):
            before = {n: _WRAPPERS[n].launches for n in kernels}
            got = solve_warm(kind, mutated, warm, compact=compact,
                             device=dev, **kw)
            if dev != "cpu":
                assert all(_WRAPPERS[n].launches > before[n]
                           for n in kernels), kernels
            if want is None:
                want = got
            _require_same_results(got, want)
    field, oracle = {
        "maxflow": ("flow", lambda p: maxflow_grid_ref(*p)),
        "assignment": ("weight", optimal_weight),
        "matching": ("cardinality", lambda a: hopcroft_karp(a)[2])}[kind]
    assert [getattr(r, field).item() for r in want] == [
        oracle(p) for p in mutated]


@pytest.mark.parametrize("kind,kw,kernels", WARM_PATHS[::2] + WARM_PATHS[3:4],
                         ids=lambda v: v if isinstance(v, str) else None)
def test_lanes_on_card_equal_no_mesh(cuda_device, kind, kw, kernels):
    """``make_solver_mesh()`` is one lane on the one card; it and two
    lanes on that card give the solve without lanes (masked and
    compacted), with the bucket padded to the two lanes."""
    from repro_torch.launch.mesh import make_solver_mesh
    bases, _ = _warm_cases(kind, 22)
    one = make_solver_mesh()
    assert one.devices == (torch.device("cuda", 0),)
    two = make_solver_mesh(2, device=cuda_device)
    for compact in (False, True):
        want = solve_batch(kind, bases, compact=compact, device=cuda_device,
                           **kw)
        for mesh in (one, two):
            stats = []
            got = solve_batch(kind, bases, compact=compact, mesh=mesh,
                              stats_out=stats, device=cuda_device, **kw)
            assert [s.n_pad for s in stats] == [-3 % len(mesh.devices)]
            _require_same_results(got, want)


def _serve_stream(seed):
    """A small mixed stream, interleaved by kind: 4 grids of 48 x 40, 4
    weight matrices of 64^2, 4 graphs of 200 x 160 at p = 4 / 160."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(4):
        out.append(("maxflow", GridProblem(*random_grid_problem(rng, 48, 40))))
        out.append(("assignment", rng.integers(0, 101, (64, 64))))
        out.append(("matching", random_bipartite(rng, 200, 160, 4 / 160)))
    return out


_SERVE_KW = {"maxflow": dict(backend="pallas"),
             "assignment": dict(backend="pallas"),
             "matching": dict(backend="pallas")}


@pytest.mark.parametrize("refill", [False, True])
def test_async_lanes_on_their_streams_equal_sync_flush(cuda_device, refill):
    """Two lanes, each on a CUDA stream of its own: 20 runs of the same
    mixed stream, each future equal to the sync flush leaf for leaf, and
    the path's kernels launched."""
    from repro_torch.serve.engine import SolverEngine
    from repro_torch.serve.scheduler import AsyncSolverEngine
    stream = _serve_stream(30)
    sync = SolverEngine(device=cuda_device, solver_kw=_SERVE_KW)
    tickets = [sync.submit(k, p) for k, p in stream]
    out = sync.flush()
    want = [out[t] for t in tickets]
    kernels = ("grid_push_decide", "bfs_relabel_sweeps", "bidding",
               "frontier")
    for _ in range(20):
        before = {n: _WRAPPERS[n].launches for n in kernels}
        with AsyncSolverEngine(device=cuda_device, n_lanes=2, max_batch=4,
                               max_delay_ms=600_000.0, refill=refill,
                               solver_kw=_SERVE_KW) as eng:
            streams = [s for lane in eng._lanes for s in lane.streams]
            assert len(set(streams)) == 2
            assert torch.cuda.default_stream(cuda_device) not in streams
            futs = [eng.submit(k, p) for k, p in stream]
            eng.flush_now()
            got = [f.result(timeout=120) for f in futs]
        _require_same_results(got, want)
        assert all(_WRAPPERS[n].launches > before[n] for n in kernels)


@pytest.mark.parametrize("kind,kw,kernels", WARM_PATHS,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_traced_solve_on_card_equals_untraced(cuda_device, kind, kw,
                                              kernels):
    """A traced flush on each kernel path records the engine's spans and
    gives the untraced flush's bits, masked and compacted."""
    from repro_torch.obs import Tracer
    from repro_torch.serve.engine import SolverEngine
    bases, _ = _warm_cases(kind, 23)
    for compact in (False, True):
        tr = Tracer()
        got = {}
        for tracer in (None, tr):
            before = {n: _WRAPPERS[n].launches for n in kernels}
            eng = SolverEngine(device=cuda_device, compact=compact,
                               tracer=tracer, solver_kw={kind: kw})
            ts = [eng.submit(kind, p) for p in bases]
            out = eng.flush()
            got[tracer] = [out[t] for t in ts]
            assert all(_WRAPPERS[n].launches > before[n] for n in kernels)
        _require_same_results(got[tr], got[None])
        names = [s.name for s in tr.spans()]
        assert names.count("submit") == len(bases)
        assert "bucket/pad" in names and "device-solve" in names


HUBERT_TRAIN_SHAPE = ((4, 1024, 1024, 16, 16, 80, 80), False)
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
    # deepseek-v2's MLA prefill at the smoke's 8 x 1024 tokens: 128 heads,
    # qk 128 + 64, v 128 (flash_fwd_mma)
    ((8, 1024, 1024, 128, 128, 192, 128), True),
    # hubert-xlarge's train step: 4 x 1024 frames, 16 heads of 80,
    # non-causal (flash_fwd_mma, dh_pad 80, dv_pad 96)
    HUBERT_TRAIN_SHAPE,
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


# K6 on one rank's heads of a model axis of m (models/attention.py,
# gqa_apply): (B, S, H, KV, dh, m, causal, dtype) -- smollm on 3 ranks
# (3 q heads over 1 kv head a rank), phi on 2 (16 over 4) and on 16 (2 q
# heads sharing 1 kv head: each q head still reads the kv head of its
# group), hubert's MHA on 2, non-causal, and smollm in bfloat16
K6_SHARDS = [
    (8, 1024, 9, 3, 64, 3, True, torch.float32),
    (8, 1024, 32, 8, 128, 2, True, torch.float32),
    (2, 256, 32, 8, 128, 16, True, torch.float32),
    (2, 512, 16, 16, 80, 2, False, torch.float32),
    (2, 512, 9, 3, 64, 3, True, torch.bfloat16),
]


@pytest.mark.parametrize("B,S,H,KV,dh,m,causal,dtype", K6_SHARDS)
def test_k6_on_a_head_shard(cuda_device, B, S, H, KV, dh, m, causal, dtype):
    """Each rank's launch on its ``H / m`` heads and the kv heads of their
    groups equals its plain version (within the sweep's tolerance) and
    the same heads of the whole launch bit for bit."""
    rng = np.random.default_rng(3)
    t = lambda *s: torch.tensor(rng.normal(size=s), dtype=dtype,  # noqa
                                device=cuda_device)
    q, k, v = t(B, S, H, dh), t(B, S, KV, dh), t(B, S, KV, dh)
    whole = fak.flash_attention_fwd(q, k, v, causal=causal)
    G, Hl = H // KV, H // m
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    for r in range(m):
        h0 = r * Hl
        kv0, nkv = h0 // G, max(Hl // G, 1)
        qs = q[:, :, h0:h0 + Hl].contiguous()
        ks, vs = (x[:, :, kv0:kv0 + nkv].contiguous() for x in (k, v))
        got = fak.flash_attention_fwd(qs, ks, vs, causal=causal)
        plain = flash_attention_ref(qs, ks, vs, causal=causal)
        assert (got.float() - plain.float()).abs().max().item() <= tol, r
        assert torch.equal(got, whole[:, :, h0:h0 + Hl]), r


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


LSE_CASES = FLASH_CASES + [(*HUBERT_TRAIN_SHAPE, torch.float32)]


@pytest.mark.parametrize("dims,causal,dtype", LSE_CASES,
                         ids=[f"{d}-{c}-{str(t)[6:]}" for d, c, t in
                              LSE_CASES])
def test_k6_lse_close_to_plain(cuda_device, dims, causal, dtype):
    """K6's log-sum-exp output (``return_lse``) against the plain
    version's, within ``chip_smoke.LSE_TOL``; the output is the call's
    without it, bit for bit."""
    rng = np.random.default_rng(11)
    q, k, v = chip_smoke.flash_inputs(rng, dims, dtype, cuda_device)
    before = fak.flash_attention_fwd.launches
    out, lse = fak.flash_attention_fwd(q, k, v, causal=causal,
                                       return_lse=True)
    assert fak.flash_attention_fwd.launches == before + 1
    _, want = flash_attention_ref(q, k, v, causal=causal, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    assert (lse - want).abs().max().item() <= chip_smoke.LSE_TOL
    assert torch.equal(out, fak.flash_attention_fwd(q, k, v, causal=causal))


# (B, Sq, Sk, H, KV, dh, dv), causal, dtype: flash_fwd_wgmma (float32, dh
# and dv <= 64) over several key chunks, flash_fwd_mma (dh above 64; qk
# 48 / v 32 in bf16; MQA), tails off the tiles, and hubert-xlarge's
# width (16 heads of 80, non-causal) over two key chunks of 512
K6_GRAD = [((2, 256, 256, 9, 3, 64, 64), True, torch.float32),
           ((1, 100, 100, 4, 2, 72, 72), True, torch.float32),
           ((1, 64, 96, 4, 1, 48, 32), False, torch.float32),
           ((1, 128, 128, 6, 2, 48, 32), True, torch.bfloat16),
           ((1, 1024, 1024, 16, 16, 80, 80), False, torch.float32)]


@pytest.mark.parametrize("dims,causal,dtype", K6_GRAD)
def test_k6_grads_close_to_cpu(cuda_device, dims, causal, dtype):
    """Under autograd the kernel wrapper goes through the attention's
    autograd Function: K6 forward (one launch, with its lse) and the plain
    backward. dq, dk, dv against the CPU path's (the plain scan forward
    and the same backward) within 1e-4 (bf16: 2e-2) x their largest
    |value|: K6's forward is within 3e-5 of the scan's."""
    from repro_torch.models.attention import flash_core
    rng = np.random.default_rng(5)
    B, Sq, Sk, H, KV, dh, dv = dims
    inputs = [rng.standard_normal(s).astype(np.float32) for s in
              ((B, Sq, H, dh), (B, Sk, KV, dh), (B, Sk, KV, dv))]
    dout = rng.standard_normal((B, Sq, H, dv)).astype(np.float32)
    grads = {}
    for dev in (cuda_device, torch.device("cpu")):
        ts = [torch.tensor(x, dtype=dtype, device=dev, requires_grad=True)
              for x in inputs]
        before = fak.flash_attention_fwd.launches
        if dev.type == "cuda":
            out = fak.flash_attention_fwd(*ts, causal=causal)
        else:
            out = flash_core(*ts, causal=causal)
        out.backward(torch.tensor(dout, dtype=dtype, device=dev))
        launched = fak.flash_attention_fwd.launches - before
        assert launched == (1 if dev.type == "cuda" else 0)
        grads[dev.type] = [t.grad.float().cpu() for t in ts]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, a, b in zip("qkv", grads["cuda"], grads["cpu"]):
        assert (a - b).abs().max().item() <= tol * b.abs().max().item(), \
            name


def test_train_step_on_card_close_to_cpu(cuda_device):
    """smollm-135m at smoke size: the loss and every gradient of
    ``loss_fn`` on the card (K6 forward twice per layer: the forward and
    the config's remat ``"full"`` recompute; the plain backward) against
    the CPU path's within 1e-4 x each leaf's largest |g| (float32 both,
    other summation orders), and one step of ``make_train_step``
    launching K6 twice per layer."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import step as tstep
    cfg = smoke_variant(get_config("smollm-135m"))
    params = numpy_params(cfg, seed=0)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=2)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = model_from_params(cfg, params, device=dev)
        batch = make_batch(dcfg, 0, dev)
        before = fak.flash_attention_fwd.launches
        loss, _ = tstep.loss_fn(model, batch)
        ps = tstep.params_of(model)
        g = torch.autograd.grad(loss, list(ps.values()))
        assert fak.flash_attention_fwd.launches - before == (
            2 * cfg.n_layers if dev.type == "cuda" else 0)
        out[dev.type] = (float(loss), [x.cpu() for x in g])
        if dev.type == "cuda":
            tcfg = tstep.TrainConfig(optimizer=AdamWConfig(warmup_steps=2))
            state = tstep.init_train_state(cfg, tcfg, model)
            before = fak.flash_attention_fwd.launches
            tstep.make_train_step(cfg, tcfg)(state, batch)
            torch.cuda.synchronize()
            assert (fak.flash_attention_fwd.launches - before
                    == 2 * cfg.n_layers)
    (la, ga), (lb, gb) = out["cuda"], out["cpu"]
    assert abs(la - lb) <= 1e-5 * abs(lb)
    for a, b in zip(ga, gb):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


def test_encoder_train_step_on_card_close_to_cpu(cuda_device):
    """hubert-xlarge's smoke variant (the frontend, sinusoidal positions,
    non-causal MHA of 32, LayerNorm, GELU) on the pipeline's frame rows:
    the loss and every gradient of ``loss_fn`` on the card (K6 forward,
    non-causal, twice per layer: the forward and the config's remat
    ``"full"`` recompute) against the CPU path's within 1e-4 x each
    leaf's largest |g|, ``embed``'s exactly zero on both, and its encoder
    forward under ``torch.inference_mode`` launching K6 once per layer
    within 1e-4 x the CPU's largest |logit|."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.train import step as tstep
    cfg = smoke_variant(get_config("hubert-xlarge"))
    params = numpy_params(cfg, seed=0)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=2,
                      frontend_dim=cfg.frontend_dim)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = model_from_params(cfg, params, device=dev)
        batch = make_batch(dcfg, 0, dev)
        before = fak.flash_attention_fwd.launches
        loss, _ = tstep.loss_fn(model, batch)
        ps = tstep.params_of(model)
        g = torch.autograd.grad(loss, list(ps.values()), allow_unused=True)
        assert g[list(ps).index("embed")] is None
        with torch.inference_mode():
            logits = apply_model(model, {"embeds": batch["embeds"]}).logits
        assert fak.flash_attention_fwd.launches - before == (
            3 * cfg.n_layers if dev.type == "cuda" else 0)
        out[dev.type] = (float(loss), [x.cpu() for x in g if x is not None],
                         logits.cpu())
    (la, ga, xa), (lb, gb, xb) = out["cuda"], out["cpu"]
    assert abs(la - lb) <= 1e-5 * abs(lb)
    assert len(ga) == len(gb) == len(ps) - 1
    for a, b in zip(ga, gb):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()
    assert (xa - xb).abs().max().item() <= 1e-4 * xb.abs().max().item()


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


def test_jamba_smoke_on_card_close_to_cpu(cuda_device):
    """jamba-v0.1's smoke variant (16 layers: attention without RoPE at
    layers 0 and 8, SSD mamba elsewhere, the MoE at every other layer): a
    greedy generation of 2 prompts of 128 tokens (2 SSD chunks) and 6 new
    tokens on the card, held to the same generation on the CPU by
    ``chip_smoke.check_serve``'s rule at 1e-4 x the step's largest |logit|
    (float32 on both sides, summed in other orders): the card's logits at
    the CPU's top-5 ids within it, and the CPU's token wherever its top-2
    gap is wider. K6 launched once per attention layer in the prefill and
    never in a decode step; no other port kernel."""
    cfg = smoke_variant(get_config("jamba-v0.1-52b"))
    params = numpy_params(cfg, seed=0)
    prompts = chip_smoke.serve_prompts(cfg.vocab, 2, 128)
    n_attn = sum(m == "attn" for m, _ in layer_plan(cfg))
    assert n_attn == 2
    runs = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = model_from_params(cfg, params, device=dev)
        steps, _, _, c_pre, c_steps, _ = chip_smoke.port_serve(
            model, torch.tensor(prompts, device=dev), 6, 134)
        on_card = dev.type == "cuda"
        assert c_pre["flash_attention_fwd"] == (n_attn if on_card else 0)
        assert all(n == 0 for k, n in c_pre.items()
                   if k != "flash_attention_fwd")
        assert all(n == 0 for c in c_steps for n in c.values())
        runs[dev.type] = steps
    want = [chip_smoke.top5_records(lg) for _, lg in runs["cpu"]]
    report = chip_smoke.check_serve(runs["cuda"], want, tol=1e-4)
    assert min(report["steps_compared"]) >= 1, report


# MoE routers: (shape, per-expert offset std, capacity, ties) -- the
# smoke's prefill shape skewed so that the auction raises prices, leading
# group axes, capacity at T, and scores full of exact ties
ROUTER_CASES = [((8192, 16), 0.5, 1280, False), ((3, 512, 16), 0.5, 80, False),
                ((2, 300, 8), 0.0, 300, False), ((4, 64, 8), 0.0, 12, True)]


@pytest.mark.parametrize("router", ["auction", "topk"])
@pytest.mark.parametrize("shape,skew,cap,ties", ROUTER_CASES, ids=str)
def test_routers_on_card_equal_cpu(cuda_device, router, shape, skew, cap,
                                   ties):
    """``auction_route`` and ``topk_route`` on the card give the CPU's
    dispatch, demand and prices bit for bit on the same scores, and its
    combine weights within 1e-6."""
    rng = np.random.default_rng(len(shape) + cap)
    if ties:
        s = rng.integers(-2, 3, shape).astype(np.float32) * 0.5
        s[..., ::3, 1] = -0.0
    else:
        s = rng.standard_normal(shape, dtype=np.float32)
        s += rng.standard_normal(shape[:-2] + (1, shape[-1]),
                                 dtype=np.float32) * np.float32(skew)
    route = {"auction": auction_route, "topk": topk_route}[router]
    got = route(torch.tensor(s, device=cuda_device), 2, cap)
    want = route(torch.tensor(s), 2, cap)
    assert all(x.device.type == "cuda" for x in got)
    assert torch.equal(got.dispatch.cpu(), want.dispatch)
    assert torch.equal(got.demand.cpu(), want.demand)
    assert bits_equal(got.prices.cpu(), want.prices)
    assert (got.combine.cpu() - want.combine).abs().max().item() <= 1e-6
    if router == "auction" and skew and cap < shape[-2]:
        assert want.prices.max() > 0             # the price rounds engaged


def test_exact_route_on_card_equals_cpu(cuda_device):
    s = np.random.default_rng(0).standard_normal((2, 64, 8), dtype=np.float32)
    got = exact_route(torch.tensor(s, device=cuda_device), 8)
    want = exact_route(torch.tensor(s), 8)
    assert torch.equal(got.dispatch.cpu(), want.dispatch)
    assert bits_equal(got.prices.cpu(), want.prices)


def test_mla_layer_on_card_close_to_cpu(cuda_device):
    """One deepseek-v2 MLA layer at full width (d_model 5120, 128 heads,
    q_lora 1536, kv_lora 512, qk 128 + 64, v 128): a prefill of 256
    tokens into 264-slot caches, then one decode step, on the card against
    the same module and weights on the CPU (the plain scan). Outputs and
    the ``c_kv`` / ``k_rope`` caches within 1e-4 x their largest |value|
    (float32 on both sides, summed in other orders); K6 launched once in
    the prefill, never in the decode step."""
    cfg = get_config("deepseek-v2-236b")
    m = cfg.mla
    cpu = init_mla(MLA(cfg, device="cpu"), torch.Generator().manual_seed(0))
    card = MLA(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    B, S, T = 2, 256, 264
    x = torch.randn(B, S + 1, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    outs = {}
    for dev, layer in ((cuda_device, card), (torch.device("cpu"), cpu)):
        cache = KVCache(torch.zeros(B, T, m.kv_lora_rank, device=dev),
                        torch.zeros(B, T, m.qk_rope_dim, device=dev),
                        torch.tensor(0, dtype=torch.int32, device=dev))
        xd = x.to(dev)
        with torch.inference_mode():
            before = fak.flash_attention_fwd.launches
            pre, cache = layer(xd[:, :S], positions=torch.arange(
                S, device=dev), cache=cache, decode=False)
            mid = fak.flash_attention_fwd.launches
            dec, cache = layer(xd[:, S:], positions=torch.tensor(
                [S], device=dev), cache=cache, decode=True)
            if dev.type == "cuda":
                torch.cuda.synchronize()
        after = fak.flash_attention_fwd.launches
        assert (mid - before, after - mid) == (
            (1, 0) if dev.type == "cuda" else (0, 0))
        assert int(cache.length) == S + 1
        outs[dev.type] = [t.cpu() for t in (pre, dec, cache.k, cache.v)]
    for got, want, what in zip(outs["cuda"], outs["cpu"],
                               ("prefill", "decode", "c_kv", "k_rope")):
        assert got.shape == want.shape, what
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), (what, err)


def test_mla_stop_rule_on_committed_constants(cuda_device):
    """The committed deepseek constants (``tests/torch_smoke_deepseek.npz``):
    the card's auction routes JAX's layer-1 gate logits as JAX did, and
    ``phase_mla``'s stops computed from the card's demand and prices are
    those from JAX's; where they stop a request at step 0, the pinned run
    has every decode step's routing to compare."""
    z = dict(np.load(chip_smoke.MLA_ROUTING))
    cfg = chip_smoke.mla_config(get_config(chip_smoke.MLA_ARCH))
    e = cfg.moe
    got = auction_route(torch.tensor(z["prefill_scores"][0],
                                     device=cuda_device), e.top_k,
                        int(z["capacity"]), n_iters=e.router_iters)
    assert np.array_equal(got.dispatch.cpu().numpy(),
                          z["prefill_auction_dispatch"][0])
    card = dict(z, prefill_auction_demand=got.demand.cpu().numpy()[None],
                prefill_auction_prices=got.prices.cpu().numpy()[None])
    stops, why = chip_smoke.moe_stops(z)
    assert chip_smoke.moe_stops(card) == (stops, why)
    if chip_smoke.local_marks(z, 0) is None and z["prefill_unstable"][0]:
        assert stops == [0] * chip_smoke.SERVE_B, why
    stable = dict(z, prefill_unstable=np.zeros_like(z["prefill_unstable"]))
    assert min(chip_smoke.moe_stops(stable)[0]) > 0


def _smoke_cells(device):
    """smollm-135m's smoke variant, bf16: a train step of 2 x 256 tokens
    and a prefill of 2 x 256 into empty caches, built on ``device``."""
    from repro_torch.launch.specs import build_model, train_cell
    from repro_torch.models.model import init_caches
    from repro_torch.serve.engine import make_prefill_step
    cfg = smoke_variant(get_config("smollm-135m"))
    train = train_cell(cfg, 2, 256, device=device)
    model = build_model(cfg, device, torch.bfloat16)
    prefill = make_prefill_step(model)
    tokens = torch.zeros((2, 256), dtype=torch.int32, device=device)
    caches = init_caches(cfg, 2, 256, device=device)
    return {"train": (train.fn, train.args),
            "prefill": (lambda m, t, c: prefill(t, c),
                        (model, tokens, caches))}


def test_meta_count_equals_card_count(cuda_device):
    """The dry run's ``meta`` count of a step is the card's: the same ops,
    K6 one op with the same count, at smoke width."""
    from repro_torch.roofline_hlo import analyze
    meta, card = _smoke_cells("meta"), _smoke_cells(cuda_device)
    for name in meta:
        want = analyze(meta[name][0], *meta[name][1])
        before = fak.flash_attention_fwd.launches
        got = analyze(card[name][0], *card[name][1])
        torch.cuda.synchronize()
        k6 = want["by_op"]["repro_torch.flash_attention_fwd"]["count"]
        assert fak.flash_attention_fwd.launches - before == k6 > 0, name
        assert (got["flops"], got["bytes"]) == (want["flops"],
                                                want["bytes"]), name
        assert got["peak_bytes"] == want["peak_bytes"], name


def test_remat_full_equals_none_on_card(cuda_device):
    """smollm-135m's smoke variant on the card, float32: the gradients
    under remat ``"full"`` and ``"dots"`` equal ``"none"``'s bit for bit,
    K6 launched twice a layer under the first two and once under
    ``"none"``."""
    from repro_torch.train.step import loss_fn, params_of
    cfg = smoke_variant(get_config("smollm-135m"))
    model = model_from_params(cfg, numpy_params(cfg, 0), device=cuda_device)
    rng = np.random.default_rng(0)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab, (2, 128)),
                             dtype=torch.int32, device=cuda_device)
             for k in ("tokens", "labels")}
    ps = params_of(model)
    grads = {}
    for mode in ("none", "full", "dots"):
        before = fak.flash_attention_fwd.launches
        loss, _ = loss_fn(model, batch, remat=mode)
        grads[mode] = torch.autograd.grad(loss, list(ps.values()))
        torch.cuda.synchronize()
        assert fak.flash_attention_fwd.launches - before == cfg.n_layers * (
            1 if mode == "none" else 2), mode
    for mode in ("full", "dots"):
        assert all(torch.equal(a, b)
                   for a, b in zip(grads[mode], grads["none"])), mode
