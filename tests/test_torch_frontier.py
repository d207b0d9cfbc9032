"""K5 ``frontier``: the port's plain version against the JAX package.

The same numpy inputs go through the JAX kernel, run in interpret mode
with small blocks so that its multi-tile merge runs, and through the
port's wrapper on CPU tensors, which runs the plain PyTorch version.
Inputs: random labels, tie-heavy labels (few distinct roots), columns
with no candidate (no labeled row, or every edge a matching edge), single
and batched (the port takes the batch axes natively; the JAX kernel is
called once per instance). Tolerance: exact equality (integers). The CUDA
kernel is held to the plain version on the card in
``test_torch_kernels_card.py``.
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
