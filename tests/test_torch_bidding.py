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
