"""K5 ``frontier``: the port's plain version against the JAX package.

The same numpy inputs go through the JAX kernel, run in interpret mode
with small blocks so that its multi-tile merge runs, and through the
port's wrapper on CPU tensors, which runs the plain PyTorch version.
Inputs: random labels, tie-heavy labels (few distinct roots), columns
with no candidate (no labeled row, or every edge a matching edge), single
and batched (the port takes the batch axes natively; the JAX kernel is
called once per instance). Tolerance: exact equality (integers). The CUDA
kernel is held to the plain version on the card in
``test_torch_kernels_card.py``; here its launch geometry is checked (every
row and column owned once, shared memory, cluster size and grid within
the card's limits), and a plain emulation of its split (per block: the
keyed minimum over its rows' listed labeled rows, chunk by chunk; per
cluster: the minimum over its blocks) is held to the plain version, the
JAX kernel and the JAX plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same

from repro.kernels.frontier.kernel import frontier as jax_frontier
from repro.kernels.frontier.ref import frontier_ref as jax_frontier_ref
from repro_torch.kernels.frontier import kernel as tk
from repro_torch.kernels.frontier.ops import frontier_op
from repro_torch.kernels.frontier.ref import INF, frontier_ref

CASES = ["random", "ties", "no_candidate", "matched_edges"]


def _inputs(case: str, batch: tuple, n_r: int, n_c: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    adj = rng.random(batch + (n_r, n_c)) < 0.3
    if case == "ties":
        root = rng.integers(0, 3, batch + (n_r,))
    else:
        root = rng.integers(0, n_r, batch + (n_r,))
    root = np.where(rng.random(batch + (n_r,)) < 0.5, root, INF)
    match = rng.integers(-1, n_c, batch + (n_r,))
    if case == "no_candidate":
        root[...] = INF
    if case == "matched_edges":
        # each row's only edge is its matching edge: nothing is a candidate
        match = rng.integers(0, n_c, batch + (n_r,))
        adj = np.zeros_like(adj)
        np.put_along_axis(adj, match[..., None], True, axis=-1)
    return adj, root.astype(np.int32), match.astype(np.int32)


def _jax(adj, root, match, **kw):
    """The JAX kernel (interpret mode), once per instance of the batch."""
    if adj.ndim == 2:
        out = jax_frontier(jnp.asarray(adj), jnp.asarray(root),
                           jnp.asarray(match), interpret=True, **kw)
        return tuple(np.asarray(x) for x in out)
    outs = [_jax(a, r, m, **kw) for a, r, m in zip(adj, root, match)]
    return tuple(np.stack([o[k] for o in outs]) for k in range(2))


@pytest.mark.parametrize("batch", [(), (3,)], ids=["single", "batched"])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_kernel(case, batch):
    adj, root, match = _inputs(case, batch, 48, 32)
    want = _jax(adj, root, match, block_rows=8, block_cols=16)
    got = tk.frontier(*map(torch.tensor, (adj, root, match)))
    assert_same(tuple(got), want)
    assert_same(tuple(frontier_op(*map(torch.tensor, (adj, root, match)))),
                want)
    if case in ("no_candidate", "matched_edges"):
        assert (got[0] == INF).all() and (got[1] == 0).all()


@pytest.mark.parametrize("n_r,n_c", [(1, 1), (5, 16), (64, 7)])
def test_plain_matches_jax_ref_at_odd_shapes(n_r, n_c):
    adj, root, match = _inputs("ties", (), n_r, n_c, seed=n_r * n_c)
    want = tuple(np.asarray(x) for x in jax_frontier_ref(
        jnp.asarray(adj), jnp.asarray(root), jnp.asarray(match)))
    assert_same(tuple(frontier_ref(*map(torch.tensor, (adj, root, match)))),
                want)


def test_batch_axes_equal_loop():
    adj, root, match = _inputs("ties", (2, 3), 16, 24)
    got = frontier_ref(*map(torch.tensor, (adj, root, match)))
    for i in range(2):
        for j in range(3):
            one = frontier_ref(*(torch.tensor(x[i, j])
                                 for x in (adj, root, match)))
            for g, o in zip(got, one):
                assert torch.equal(g[i, j], o)


# (B, n_r, n_c): one row, one past a cluster's span of rows, many chunks
# per block, the smoke's shape, odd widths (the scalar path) and more
# instances than clusters of columns
GEOMETRY_SHAPES = [(1, 1, 1), (1, 1, 16), (2, tk.CLUSTER * tk.CHUNK + 1, 512),
                   (1, 5000, 512), (4, 4096, 4096), (2, 600, 1024),
                   (3, 257, 48), (1, 300, 37), (5, 7, 100), (7, 33, 1040)]


def _check_geometry(g, B, n_r, n_c):
    """Every row in exactly one block of a cluster, every column in
    exactly one strip and one block's share of it, within the limits."""
    owners = np.zeros(n_r, dtype=int)
    for rank in range(g.cluster):
        lo = min(n_r, rank * g.rows_per_block)
        owners[lo:min(n_r, lo + g.rows_per_block)] += 1
    assert (owners == 1).all()
    strips, rem = divmod(g.grid[0], g.cluster)
    assert rem == 0 and g.grid[1] == B <= tk.GRID_Y_MAX
    cols = np.zeros(strips * g.strip, dtype=int)
    share = -(-g.strip // g.cluster)      # a block's columns of its strip
    for s in range(strips):
        for rank in range(g.cluster):
            lo = s * g.strip + rank * share
            cols[lo:min(lo + share, (s + 1) * g.strip)] += 1
    assert (cols == 1).all() and (strips - 1) * g.strip < n_c <= cols.size
    assert g.strip == 32 * g.vec and g.threads == tk.WARPS * 32
    assert g.smem_bytes == tk.WARPS * g.strip * 8 <= tk.SMEM_MAX
    assert 1 <= g.cluster <= tk.CLUSTER_MAX
    assert g.cluster & (g.cluster - 1) == 0 and g.strip % g.cluster == 0


@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
@pytest.mark.parametrize("cluster", [None, 1, tk.CLUSTER, tk.CLUSTER_MAX])
def test_launch_geometry_covers_every_row_and_column_once(shape, cluster):
    for aligned in (False, shape[-1] % 16 == 0):
        g = tk.launch_geometry(*shape, aligned, cluster)
        _check_geometry(g, *shape)
        assert g.vec == (16 if aligned else 1)
        assert g.cluster in ((tk.CLUSTER, tk.CLUSTER_MAX) if cluster is None
                             else (cluster,))


def test_launch_geometry_fills_the_card():
    """At the smoke's 4 x 4096^2: the vector path, a portable cluster of
    8 blocks of 512 rows each, and at least one block per SM of the
    H100's 132."""
    g = tk.launch_geometry(4, 4096, 4096, True)
    assert (g.vec, g.cluster, g.rows_per_block) == (16, 8, 512)
    assert g.cluster == tk.CLUSTER <= 8 and g.grid == (64, 4)
    assert g.grid[0] * g.grid[1] >= tk.SMS == 132
    assert g.smem_bytes == 32768 and g.threads == 256
    assert g.rows_per_block <= tk.CHUNK       # one chunk per block


@pytest.mark.parametrize("shape,cluster,blocks", [
    ((1, 4096, 4096), 16, 128), ((2, 4096, 4096), 16, 256),
    ((3, 4096, 4096), 8, 192), ((1, 20000, 512), 16, 16),
    ((1, 300, 37), 16, 32), ((9, 300, 37), 8, 144)])
def test_launch_geometry_takes_clusters_of_16_where_8_leave_sms_idle(
        shape, cluster, blocks):
    """Clusters of ``CLUSTER`` blocks where they give every SM a block,
    else of ``CLUSTER_MAX``: twice the blocks for one instance of 4096^2
    or a tall, narrow one."""
    g = tk.launch_geometry(*shape, shape[-1] % 16 == 0)
    assert (g.cluster, g.grid[0] * g.grid[1]) == (cluster, blocks)
    _check_geometry(g, *shape)


def _emulate_clusters(adj, root, match, g):
    """The kernel's split in plain torch: per block of a cluster, the
    keyed minimum (root << 32 | row, an int64 whose order is the order of
    (root, row)) over the labeled rows of each CHUNK of its rows, carried
    across the chunks; per cluster, the minimum over its blocks."""
    *batch, n_r, n_c = adj.shape
    none = torch.iinfo(torch.int64).max
    cols = torch.arange(n_c, dtype=torch.int32)
    best = torch.full(tuple(batch) + (n_c,), none, dtype=torch.int64)
    for rank in range(g.cluster):
        lo = min(n_r, rank * g.rows_per_block)
        hi = min(n_r, lo + g.rows_per_block)
        block = torch.full_like(best, none)
        for r0 in range(lo, hi, tk.CHUNK):
            rows = torch.arange(r0, min(hi, r0 + tk.CHUNK))
            rt, mt = root[..., rows], match[..., rows]
            cand = (adj[..., rows, :] & (rt < INF).unsqueeze(-1)
                    & (mt.unsqueeze(-1) != cols))
            key = (rt.to(torch.int64) << 32 | rows).unsqueeze(-1)
            block = torch.minimum(block, torch.where(
                cand, key, none).amin(dim=-2))
        best = torch.minimum(best, block)
    found = best != none
    return (torch.where(found, best >> 32, INF).to(torch.int32),
            torch.where(found, best & 0xFFFFFFFF, 0).to(torch.int32))


@pytest.mark.parametrize("cluster", [1, 2, tk.CLUSTER, tk.CLUSTER_MAX])
@pytest.mark.parametrize("batch", [(), (3,)], ids=["single", "batched"])
@pytest.mark.parametrize("case", CASES)
def test_cluster_split_matches_jax_kernel(case, batch, cluster):
    adj, root, match = _inputs(case, batch, 48, 32)
    want = _jax(adj, root, match, block_rows=8, block_cols=16)
    args = tuple(map(torch.tensor, (adj, root, match)))
    for aligned in (True, False):
        g = tk.launch_geometry(int(np.prod(batch)), 48, 32, aligned, cluster)
        assert_same(_emulate_clusters(*args, g), want)


@pytest.mark.parametrize("n_r,n_c,cluster", [
    (300, 37, tk.CLUSTER), (257, 48, tk.CLUSTER), (1, 1, tk.CLUSTER),
    (2 * tk.CHUNK + 77, 37, 2), (tk.CHUNK + 1, 48, 1),
    (1, 16, tk.CLUSTER_MAX)])
def test_cluster_split_matches_jax_ref_at_odd_shapes(n_r, n_c, cluster):
    """Odd shapes, blocks with no rows, and blocks that loop over more
    than one chunk (2 CHUNK + 77 rows over 2 blocks, CHUNK + 1 in one)."""
    adj, root, match = _inputs("ties", (), n_r, n_c, seed=n_r + n_c)
    want = tuple(np.asarray(x) for x in jax_frontier_ref(
        jnp.asarray(adj), jnp.asarray(root), jnp.asarray(match)))
    args = tuple(map(torch.tensor, (adj, root, match)))
    g = tk.launch_geometry(1, n_r, n_c, n_c % 16 == 0, cluster)
    got = _emulate_clusters(*args, g)
    assert_same(got, want)
    assert_same(got, frontier_ref(*args))


def test_cluster_split_ties_cross_blocks():
    """Every labeled row has the same root, so each column's minimum is
    decided by the row alone, across the blocks of a cluster."""
    adj, root, match = _inputs("random", (2,), 700, 64, seed=9)
    root = np.where(root < INF, 5, INF).astype(np.int32)
    args = tuple(map(torch.tensor, (adj, root, match)))
    want = frontier_ref(*args)
    assert bool((want[0] == 5).any())
    for cluster in (2, tk.CLUSTER, tk.CLUSTER_MAX):
        g = tk.launch_geometry(2, 700, 64, True, cluster)
        assert_same(_emulate_clusters(*args, g), want)


def test_wrapper_counts_no_launch_on_cpu_and_checks_inputs():
    adj, root, match = map(torch.tensor, _inputs("random", (2,), 16, 8))
    before = tk.frontier.launches
    tk.frontier(adj, root, match)
    assert tk.frontier.launches == before
    with pytest.raises(ValueError, match="root_row"):
        tk.frontier(adj, root[:, :4].contiguous(), match)
    with pytest.raises(ValueError, match="match_row"):
        tk.frontier(adj, root, match.to(torch.int64))
    with pytest.raises(ValueError, match="adj must be"):
        tk.frontier(adj.to(torch.uint8), root, match)
    with pytest.raises(ValueError, match="n_r >= 1"):
        tk.frontier(adj[:, :0], root[:, :0], match[:, :0])
