"""K4 ``bidding``: the port's plain version against the JAX package.

The same numpy inputs go through the JAX kernel, run in interpret mode
with small blocks so that its multi-tile merge runs, and through the
port's wrapper on CPU tensors, which runs the plain PyTorch version.
Inputs: random costs, tie-heavy costs (values in 0..3), rows with every
entry masked, single and batched (the port takes the batch axes natively;
the JAX kernel is called once per instance). Tolerance: exact equality
(integers). The CUDA kernel is held to the plain version on the card in
``test_torch_kernels_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same

from repro.kernels.bidding.kernel import bidding as jax_bidding
from repro.kernels.bidding.ref import bidding_ref as jax_bidding_ref
from repro_torch.kernels.bidding import kernel as tk
from repro_torch.kernels.bidding.ops import bidding_op
from repro_torch.kernels.bidding.ref import INF, bidding_ref

CASES = ["random", "ties", "masked_rows", "all_masked"]


def _inputs(case: str, batch: tuple, n_r: int, n_c: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    shape = batch + (n_r, n_c)
    if case == "ties":
        c = rng.integers(0, 4, shape)
        p = rng.integers(0, 2, batch + (n_c,))
    else:
        c = -(n_c + 1) * rng.integers(0, 101, shape)
        p = rng.integers(-5000, 5000, batch + (n_c,))
    mask = rng.random(shape) < 0.3
    if case == "masked_rows":
        mask[..., ::3, :] = True
    if case == "all_masked":
        mask[...] = True
    return c.astype(np.int32), p.astype(np.int32), mask


def _jax(c, p, mask, **kw):
    """The JAX kernel (interpret mode), once per instance of the batch."""
    if c.ndim == 2:
        out = jax_bidding(jnp.asarray(c), jnp.asarray(p), jnp.asarray(mask),
                          interpret=True, **kw)
        return tuple(np.asarray(x) for x in out)
    outs = [_jax(ci, pi, mi, **kw) for ci, pi, mi in zip(c, p, mask)]
    return tuple(np.stack([o[k] for o in outs]) for k in range(3))


@pytest.mark.parametrize("batch", [(), (3,)], ids=["single", "batched"])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_kernel(case, batch):
    c, p, mask = _inputs(case, batch, 32, 48)
    want = _jax(c, p, mask, block_rows=8, block_cols=16)
    got = tk.bidding(*map(torch.tensor, (c, p, mask)))
    assert_same(tuple(got), want)
    assert_same(tuple(bidding_op(*map(torch.tensor, (c, p, mask)))), want)
    if case == "all_masked":
        assert (got[0] == INF).all() and (got[1] == 0).all()
        assert (got[2] == INF).all()


@pytest.mark.parametrize("n_r,n_c", [(1, 1), (8, 1), (16, 5), (64, 64)])
def test_plain_matches_jax_ref_at_odd_shapes(n_r, n_c):
    """Single columns (min2 is INF) and widths no tile divides."""
    c, p, mask = _inputs("ties", (), n_r, n_c, seed=n_r + n_c)
    want = tuple(np.asarray(x) for x in jax_bidding_ref(
        jnp.asarray(c), jnp.asarray(p), jnp.asarray(mask)))
    assert_same(tuple(bidding_ref(*map(torch.tensor, (c, p, mask)))), want)


def test_batch_axes_equal_loop():
    c, p, mask = _inputs("ties", (2, 3), 16, 24)
    got = bidding_ref(*map(torch.tensor, (c, p, mask)))
    for i in range(2):
        for j in range(3):
            one = bidding_ref(*(torch.tensor(x[i, j]) for x in (c, p, mask)))
            for g, o in zip(got, one):
                assert torch.equal(g[i, j], o)


def test_wrapper_counts_no_launch_on_cpu_and_checks_inputs():
    c, p, mask = map(torch.tensor, _inputs("random", (2,), 8, 16))
    before = tk.bidding.launches
    tk.bidding(c, p, mask)
    assert tk.bidding.launches == before
    with pytest.raises(ValueError, match="p_y"):
        tk.bidding(c, p[:, :8].contiguous(), mask)
    with pytest.raises(ValueError, match="mask"):
        tk.bidding(c, p, mask.to(torch.int32))
    with pytest.raises(ValueError, match="c must be"):
        tk.bidding(c.to(torch.int64), p, mask)
    with pytest.raises(ValueError, match="contiguous"):
        tk.bidding(c.transpose(-1, -2), p[:, :8].contiguous(),
                   mask.transpose(-1, -2).contiguous())
    with pytest.raises(ValueError, match="n_c >= 1"):
        tk.bidding(c[..., :0], p[..., :0], mask[..., :0])


# K4's launch on the card: launch_geometry and a plain emulation of the
# kernel's decomposition (8 rows a block, a warp a row, a lane's columns,
# the shuffle merge). The CUDA kernel itself is held to the plain version
# in test_torch_kernels_card.py.

GEOMETRY_SHAPES = [(8, 512, 512), (1, 512, 512), (2, 2048, 2048),
                   (1, 64, 1), (2, 40, 37), (3, 96, 516), (1, 7, 4096),
                   (70000, 2, 16), (5, 37, 32), (3, 5, 6)]


def _rows(g, B, n_r):
    """``(block, warp, row)`` of every row the launch folds, rows of the
    flattened batch."""
    for k in range(g.blocks):
        for w in range(g.rows_per_block):
            r = k * g.rows_per_block + w
            if r < B * n_r:
                yield k, w, r


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("shape", GEOMETRY_SHAPES,
                         ids=["x".join(map(str, s)) for s in GEOMETRY_SHAPES])
def test_launch_geometry_owns_every_row_once(shape, aligned):
    """Every row in exactly one block and warp, blocks that hold rows of
    two instances where n_r is not a multiple of 8, no block without a
    row, a 1-D grid for B above 65535, and the vector path only where
    n_c % 4 == 0 and the base pointers are aligned."""
    B, n_r, n_c = shape
    g = tk.launch_geometry(B, n_r, n_c, aligned)
    assert g.threads == tk.THREADS == 32 * g.rows_per_block
    assert g.rows_per_block == tk.WARPS
    owned = np.zeros(B * n_r, dtype=np.int64)
    blocks, crossing = set(), set()
    for k, _, r in _rows(g, B, n_r):
        owned[r] += 1
        blocks.add(k)
        if r // n_r != (k * g.rows_per_block) // n_r:
            crossing.add(k)
    assert (owned == 1).all() and blocks == set(range(g.blocks))
    assert bool(crossing) == (n_r % g.rows_per_block != 0 and B > 1)
    assert g.vec == (aligned and n_c % 4 == 0)


def test_launch_geometry_at_the_smoke_shape():
    """8 x 512^2: 512 blocks of 8 warps (one wave of 4 blocks an SM on an
    H100's 132), the vector path."""
    assert tk.launch_geometry(8, 512, 512, True) == tk.Geometry(
        1, 8, 512, 256)
    with pytest.raises(ValueError, match="no rows"):
        tk.launch_geometry(0, 512, 512, True)


def _emulate(c, p, mask, g):
    """K4's decomposition in plain torch: warp w of block k folds row
    8k + w of the flattened batch with its own instance's prices; on the
    vector path lane l owns columns 4l .. 4l + 3 of every 128-column chunk,
    two chunks' loads at a time, folded chunk by chunk, on the scalar path
    columns l, l + 32, ...; then the lanes merge by the xor butterfly of
    warp shuffles. All rows at once: rows do not interact."""
    *batch, n_r, n_c = c.shape
    B = int(np.prod(batch, dtype=np.int64))
    rows = torch.tensor([r for _, _, r in _rows(g, B, n_r)])
    cf, mf = c.reshape(-1, n_c)[rows], mask.reshape(-1, n_c)[rows]
    pf = p.reshape(B, n_c)[rows // n_r]
    big = torch.iinfo(torch.int32).max
    lanes = torch.arange(32)
    n = len(rows)
    m1 = torch.full((n, 32), big, dtype=torch.int32)
    a1 = torch.full((n, 32), big, dtype=torch.int32)
    m2 = torch.full((n, 32), INF, dtype=torch.int32)
    if g.vec:
        order = [s + 128 * k + 4 * lanes + e for s in range(0, n_c, 256)
                 for k in range(2) for e in range(4)]
    else:
        order = [s + lanes for s in range(0, n_c, 32)]
    for j in order:
        ok = j < n_c
        jj = torch.where(ok, j, 0)
        v = torch.where(mf[:, jj], INF, cf[:, jj] - pf[:, jj])
        take = ok & ((v < m1) | ((v == m1) & (jj < a1)))
        keep = ok & ~take
        m2 = torch.where(take, torch.minimum(m2, m1),
                         torch.where(keep, torch.minimum(m2, v), m2))
        m1 = torch.where(take, v, m1)
        a1 = torch.where(take, jj.to(torch.int32), a1)
    for o in (16, 8, 4, 2, 1):
        u1, ua, u2 = m1[:, lanes ^ o], a1[:, lanes ^ o], m2[:, lanes ^ o]
        take = (u1 < m1) | ((u1 == m1) & (ua < a1))
        m2 = torch.minimum(torch.minimum(m2, u2), torch.where(take, m1, u1))
        m1, a1 = torch.where(take, u1, m1), torch.where(take, ua, a1)
    out = torch.zeros((3, B * n_r), dtype=torch.int32)
    out[:, rows] = torch.stack([m1[:, 0], a1[:, 0], m2[:, 0]])
    return tuple(x.reshape(tuple(batch) + (n_r,)) for x in out)


# (batch, n_r, n_c): blocks across instances of 37 rows; instances of 3
# rows (a block holds rows of three); a width the vector path does not
# take; rows wider than one 256-column pair of chunks, with a ragged last
# chunk; one instance
EMULATED = [((5,), 37, 32), ((7,), 3, 48), ((2,), 40, 37), ((3,), 9, 1040),
            ((), 16, 132)]


@pytest.mark.parametrize("aligned", [True, False], ids=["vector", "scalar"])
@pytest.mark.parametrize("case", ["ties", "masked_rows", "all_masked"])
@pytest.mark.parametrize("batch,n_r,n_c", EMULATED)
def test_decomposition_matches_plain_and_jax_kernel(batch, n_r, n_c, case,
                                                    aligned):
    """The kernel's decomposition, emulated, gives the plain version's
    bits and the JAX kernel's (interpret mode): ties, fully masked rows
    and blocks across instances included."""
    c, p, mask = _inputs(case, batch, n_r, n_c, seed=n_r * n_c)
    B = int(np.prod(batch, dtype=np.int64))
    g = tk.launch_geometry(B, n_r, n_c, aligned)
    assert g.vec == (aligned and n_c % 4 == 0)
    got = _emulate(*map(torch.tensor, (c, p, mask)), g)
    assert_same(got, tuple(bidding_ref(*map(torch.tensor, (c, p, mask)))))
    if n_c <= 512:
        assert_same(got, _jax(c, p, mask))
