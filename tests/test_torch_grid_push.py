"""K1 ``grid_push_decide`` and K2 ``grid_push_decide_sched``: the port
against the JAX package.

The same numpy inputs (seeded generators, and mid-solve states carried
across with ``repro_torch.interop``) go through the JAX functions, whose
Pallas kernels run in interpret mode, and through the port on the CPU,
where each wrapper runs its plain PyTorch version. Tolerance: exact
equality of every leaf (``np.array_equal``, dtypes included), because all
instances are integer-valued. The kernels themselves are held to their
plain versions on the card in ``test_torch_kernels_card.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same

from repro.core.maxflow import grid as jg
from repro.core.maxflow.ref import checkerboard_problem, random_grid_problem
from repro.kernels.grid_push import kernel as jk
from repro.kernels.grid_push import ops as jops
from repro_torch.interop import to_torch
from repro_torch.kernels.grid_push import kernel as tk
from repro_torch.kernels.grid_push import ops as tops


_jacobi_round_jit = jax.jit(jg.jacobi_round)


def _jax_state(probs, rounds: int):
    """A JAX mid-solve state: init (round-0 BFS), then ``rounds`` rounds.

    ``probs`` is a list of (cap, cs, ct); one problem gives an unbatched
    state, several a (B, ...) state with cap (4, B, H, W).
    """
    if len(probs) == 1:
        cap, cs, ct = probs[0]
    else:
        cap = np.stack([p[0] for p in probs], axis=1)
        cs = np.stack([p[1] for p in probs])
        ct = np.stack([p[2] for p in probs])
    st = jg._grid_init_jit(jnp.asarray(cap), jnp.asarray(cs),
                           jnp.asarray(ct), bfs_max_iters=0)
    n = cs.shape[-2] * cs.shape[-1] + 2
    for _ in range(rounds):
        st = _jacobi_round_jit(st, jnp.int32(n))
    return st, n


def _problems(H, W, seeds):
    return [random_grid_problem(np.random.default_rng(s), H, W)
            for s in seeds]


@pytest.mark.parametrize("H,W,seeds,rounds", [
    (16, 16, [0], 0), (16, 32, [1], 3), (32, 32, [2], 7),
    (16, 16, [3, 4, 5], 2), (32, 16, [6, 7], 5)])
def test_decide_matches_jax(H, W, seeds, rounds):
    jst, n = _jax_state(_problems(H, W, seeds), rounds)
    nbr = jnp.stack([jg._nbr_h(jst.h, d) for d in range(4)], axis=0)
    want = jk.grid_push_decide(jst.e, jst.h, jst.cap, nbr, jst.cap_src,
                               jst.cap_sink, n, block_h=16, block_w=16,
                               interpret=True)
    tst = to_torch(jst, "cpu")
    got = tk.grid_push_decide(tst.e, tst.h, tst.cap, tst.cap_src,
                              tst.cap_sink, n)
    assert_same(got, want)


def test_decide_edge_cases():
    """Ties and INF: sink beats everything, a tie at N goes to the source,
    no relabel when every candidate is INF."""
    H, W = 2, 3
    n = H * W + 2
    e = torch.tensor([[1., 2., 0.], [3., 4., 5.]])
    h = torch.tensor([[n + 1, n, 0], [n + 1, 2, 1]], dtype=torch.int32)
    cap = torch.zeros((4, H, W))
    cap[3, 0, 0] = 2.          # (0,0) -> (0,1), a neighbour at height N
    cap[1, 1, 1] = 1.          # (1,1) DOWN leaves the grid: INF
    cs = torch.tensor([[1., 1., 0.], [1., 0., 0.]])
    ct = torch.tensor([[0., 0., 0.], [0., 0., 3.]])
    h_new, delta = tk.grid_push_decide(e, h, cap, cs, ct, n)
    nbr = jnp.stack([jg._nbr_h(jnp.asarray(h.numpy()), d) for d in range(4)])
    want = jk.grid_push_decide(*(jnp.asarray(x.numpy()) for x in (e, h, cap)),
                               nbr, jnp.asarray(cs.numpy()),
                               jnp.asarray(ct.numpy()), n, interpret=True)
    assert_same((h_new, delta), want)
    assert int(h_new[1, 1]) == 2 and int(h_new[0, 2]) == 0
    assert float(delta[1, 0, 0]) == 1.0       # tie at N: the source
    assert float(delta[0, 1, 2]) == 3.0       # the sink wins


@pytest.mark.parametrize("H,W,B", [(128, 128, 2), (96, 64, 3), (64, 200, 1)])
def test_tile_schedule_matches_jax(H, W, B):
    rng = np.random.default_rng(H + W + B)
    tiles = rng.random((B, 4, 4)) < 0.4
    active = (rng.random((B, H, W)) < 0.01) & np.kron(
        tiles, np.ones((H // 4 + 1, W // 4 + 1), bool))[:, :H, :W]
    bh, bw = tops.tile_shape(H, W)
    want = jops.tile_schedule(jnp.asarray(active), bh, bw)
    got = tops.tile_schedule(torch.tensor(active), bh, bw)
    assert_same(got, want)


@pytest.mark.parametrize("H,W,seeds,rounds", [
    (128, 128, [0, 1], 40), (64, 96, [2], 25), (32, 32, [3, 4, 5], 9)])
def test_decide_sched_matches_jax(H, W, seeds, rounds):
    jst, n = _jax_state(_problems(H, W, seeds), rounds)
    B = len(seeds)
    e, h = jst.e.reshape(B, H, W), jst.h.reshape(B, H, W)
    cap = jst.cap.reshape(4, B, H, W)
    cs, ct = jst.cap_src.reshape(B, H, W), jst.cap_sink.reshape(B, H, W)
    bh, bw = tops.tile_shape(H, W)
    sched, nact = jops.tile_schedule(e > 0, bh, bw)
    nbr = jnp.stack([jg._nbr_h(h, d) for d in range(4)], axis=0)
    want = jk.grid_push_decide_sched(e, h, cap, nbr, cs, ct, sched, nact, n,
                                     block_h=bh, block_w=bw, interpret=True)
    t = to_torch((e, h, cap, cs, ct, sched, nact), "cpu")
    got = tk.grid_push_decide_sched(*t, n, block_h=bh, block_w=bw)
    assert_same(got, want)
    # and it is the full K1 decision: idle tiles hold no active node
    assert_same(got, tk.grid_push_decide(*t[:5], n))


def test_decide_sched_identity_tiles():
    """Tiles past n_active are copied through even if they hold excess."""
    rng = np.random.default_rng(5)
    cap, cs, ct = random_grid_problem(rng, 128, 128)
    e = torch.tensor(cs)[None]
    h = torch.zeros((1, 128, 128), dtype=torch.int32)
    sched = torch.tensor([[2, 0, 3, 1]], dtype=torch.int32)
    nact = torch.tensor([1], dtype=torch.int32)
    args = (e, h, torch.tensor(cap)[:, None], torch.tensor(cs)[None],
            torch.tensor(ct)[None], sched, nact, 128 * 128 + 2)
    h_new, delta = tk.grid_push_decide_sched(*args, block_h=64, block_w=64)
    full_h, full_d = tk.grid_push_decide(*args[:5], args[-1])
    tile2 = (slice(None), slice(64, 128), slice(0, 64))   # tile id 2
    assert torch.equal(h_new[tile2], full_h[tile2])
    assert torch.equal(delta[(slice(None),) + tile2], full_d[(slice(None),)
                                                              + tile2])
    rest = torch.ones_like(h, dtype=torch.bool)
    rest[tile2] = False
    assert torch.equal(h_new[rest], h[rest])
    assert not delta[:, rest].any()


@pytest.mark.parametrize("seeds", [[0], [1, 2, 3]])
def test_jacobi_round_pallas_matches_jax(seeds):
    jst, n = _jax_state(_problems(32, 32, seeds), 0)
    tst = to_torch(jst, "cpu")
    for _ in range(6):
        jst = jops.jacobi_round_pallas(jst, jnp.int32(n), block_h=16,
                                       block_w=16, interpret=True)
        tst = tops.jacobi_round_pallas(tst, n)
        assert_same(tst, jst)


@pytest.mark.parametrize("maker", [
    lambda: _problems(128, 64, [4]),
    lambda: _problems(64, 64, [5, 6]),
    lambda: [checkerboard_problem(64, 128)]])
def test_jacobi_round_scheduled_matches_jax(maker):
    jst, n = _jax_state(maker(), 0)
    tst = to_torch(jst, "cpu")
    for _ in range(5):
        jst, j_ret = jops.jacobi_round_scheduled(jst, jnp.int32(n),
                                                 interpret=True)
        tst, t_ret = tops.jacobi_round_scheduled(tst, n)
        assert_same(tst, jst)
        assert_same(t_ret, j_ret)


def test_wrappers_check_inputs():
    e = torch.zeros((8, 8))
    h = torch.zeros((8, 8), dtype=torch.int32)
    cap = torch.zeros((4, 8, 8))
    with pytest.raises(TypeError, match="h must be torch.int32"):
        tk.grid_push_decide(e, h.float(), cap, e, e, 66)
    with pytest.raises(ValueError, match="cap"):
        tk.grid_push_decide(e, h, cap[:3], e, e, 66)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tk.grid_push_decide(*(t.to("meta") for t in (e, h, cap, e, e)), 66)
    with pytest.raises(ValueError, match="must divide"):
        tk.grid_push_decide_sched(
            e[None], h[None], cap[:, None], e[None], e[None],
            torch.zeros((1, 1), dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), 66, block_h=3, block_w=8)
