"""The slice: grid max-flow through ``maxflow_grid`` / ``maxflow_grid_batch``,
the port against the JAX package.

For every backend (``xla``, ``multipush``, ``pallas``, ``balanced``) the
same numpy problems (``random_grid_problem`` at 16² and 32², every
``ADVERSARIAL_GENERATORS`` family at 32²) go through the JAX solver (Pallas
kernels in interpret mode) and through the port with ``device="cpu"``
(each kernel wrapper runs its plain version). Checked: ``flow``, ``cut``,
every state leaf, ``rounds``, ``heuristics`` and ``converged`` against
JAX; ``flow`` against the scipy oracle; ``check_no_violations`` against
JAX's verdict. In the port, a batch equals a loop of single solves.
Tolerance: exact equality (``np.array_equal``, dtypes included), because
every instance is integer-valued.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same

from repro.core.maxflow import grid as jg
from repro.core.maxflow.ref import ADVERSARIAL_GENERATORS as JAX_GENERATORS
from repro.core.maxflow.ref import random_grid_problem as jax_random_problem
from repro.core.masking import freeze as jax_freeze
from repro_torch import resolve_device
from repro_torch.core.masking import freeze
from repro_torch.core.maxflow import grid as tg
from repro_torch.core.maxflow.ref import (ADVERSARIAL_GENERATORS,
                                          maxflow_grid_ref,
                                          random_grid_problem)
from repro_torch.interop import to_numpy, to_torch
from repro_torch.launch.mesh import make_solver_mesh

BACKENDS = list(tg.VALID_BACKENDS)
PROBLEMS = ["grid16", "grid32"] + sorted(ADVERSARIAL_GENERATORS)


def _problem(name, seed=0):
    rng = np.random.default_rng(seed)
    if name.startswith("grid"):
        n = int(name[len("grid"):])
        return random_grid_problem(rng, n, n)
    return ADVERSARIAL_GENERATORS[name](rng, 32, 32)


@pytest.mark.parametrize("name", PROBLEMS)
def test_generators_match_jax(name):
    """The port's own generator copies draw the same instances."""
    rng = np.random.default_rng(3)
    if name.startswith("grid"):
        n = int(name[len("grid"):])
        want = jax_random_problem(rng, n, n)
    else:
        want = JAX_GENERATORS[name](rng, 32, 32)
    assert_same(_problem(name, 3), want)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", PROBLEMS)
def test_maxflow_grid_matches_jax(name, backend):
    cap, cs, ct = _problem(name)
    want = jg.maxflow_grid(jg.GridProblem(*map(jnp.asarray, (cap, cs, ct))),
                           backend=backend, max_rounds=500_000)
    got = tg.maxflow_grid(tg.GridProblem(cap, cs, ct), backend=backend,
                          max_rounds=500_000, device="cpu")
    assert_same(got, want)
    assert bool(got.converged)
    assert float(got.flow) == maxflow_grid_ref(cap, cs, ct)
    ok = bool(tg.check_no_violations(got.state))
    assert ok == bool(jg.check_no_violations(want.state))
    assert ok or backend == "balanced"


@pytest.mark.parametrize("backend", BACKENDS)
def test_maxflow_grid_batch_matches_jax_and_singles(backend):
    probs = [_problem("grid32", s) for s in range(3)]
    probs.append(_problem("checkerboard"))
    cap, cs, ct = (np.stack([p[k] for p in probs]) for k in range(3))
    want = jg.maxflow_grid_batch(
        jg.GridProblem(*map(jnp.asarray, (cap, cs, ct))), backend=backend,
        max_rounds=500_000)
    got = tg.maxflow_grid_batch(tg.GridProblem(cap, cs, ct), backend=backend,
                                max_rounds=500_000, device="cpu")
    assert_same(got, want)
    assert got.state.cap.shape == (4, 4, 32, 32)
    assert got.flow.tolist() == [float(maxflow_grid_ref(*p)) for p in probs]
    for b, p in enumerate(probs):
        single = to_numpy(tg.maxflow_grid(tg.GridProblem(*p), backend=backend,
                                          max_rounds=500_000, device="cpu"))
        batched = to_numpy(got)
        for key in ("flow", "cut", "rounds", "converged", "heuristics"):
            assert np.array_equal(batched[key][b], single[key]), key
        for key, v in batched["state"].items():
            assert np.array_equal(v[b], single["state"][key]), key


def test_max_rounds_cut_matches_jax():
    """A solve cut short by max_rounds: same partial state and counters,
    converged False; the batch keeps one instance live past the other."""
    probs = [_problem("checkerboard"), _problem("long_path")]
    cap, cs, ct = (np.stack([p[k] for p in probs]) for k in range(3))
    for backend in ("xla", "balanced"):
        want = jg.maxflow_grid_batch(
            jg.GridProblem(*map(jnp.asarray, (cap, cs, ct))),
            backend=backend, max_rounds=96)
        got = tg.maxflow_grid_batch(tg.GridProblem(cap, cs, ct),
                                    backend=backend, max_rounds=96,
                                    device="cpu")
        assert_same(got, want)
    assert not bool(got.converged.all())


def test_bfs_max_iters_binding_matches_jax():
    cap, cs, ct = _problem("long_path")
    for backend in ("pallas", "balanced"):
        want = jg.maxflow_grid(jg.GridProblem(*map(jnp.asarray,
                                                   (cap, cs, ct))),
                               backend=backend, bfs_max_iters=5)
        got = tg.maxflow_grid(tg.GridProblem(cap, cs, ct), backend=backend,
                              bfs_max_iters=5, device="cpu")
        assert_same(got, want)


def test_freeze_matches_jax():
    """Per-instance select with the grid state's leading direction axis."""
    rng = np.random.default_rng(0)
    live = np.array([True, False, True])
    new = jg.GridFlowState(*(jnp.asarray(rng.integers(0, 9, s), dt)
                             for s, dt in (((3, 4, 5), jnp.float32),
                                           ((3, 4, 5), jnp.int32),
                                           ((4, 3, 4, 5), jnp.float32),
                                           ((3, 4, 5), jnp.float32),
                                           ((3, 4, 5), jnp.float32),
                                           ((3,), jnp.float32),
                                           ((3,), jnp.float32))))
    old = jg.GridFlowState(*(jnp.zeros_like(x) for x in new[:7]))
    lead = lambda a: 1 if a.ndim - 1 == 3 else 0   # noqa: E731
    want = jax_freeze(jnp.asarray(live), new, old, lead_axes_fn=lead)
    got = freeze(torch.tensor(live), to_torch(new, "cpu"),
                 to_torch(old, "cpu"), lead_axes_fn=lead)
    assert_same(got, want)


def test_interop_round_trip():
    """JAX state -> port (internal layout kept) -> numpy dict."""
    cap, cs, ct = _problem("grid16")
    st = jg._grid_init_jit(jnp.asarray(cap), jnp.asarray(cs), jnp.asarray(ct),
                           bfs_max_iters=0)
    port = to_torch(st, "cpu")
    assert isinstance(port, tg.GridFlowState)
    assert port.cap.shape == (4, 16, 16) and port.h.dtype == torch.int32
    assert_same(to_numpy(port), to_numpy(st))
    assert to_numpy(port)["heur"].dtype == np.int32


def test_shape_and_backend_errors():
    cap, cs, ct = _problem("grid16")
    single = tg.GridProblem(cap, cs, ct)
    batch = tg.GridProblem(cap[None], cs[None], ct[None])
    with pytest.raises(ValueError, match="maxflow_grid_batch"):
        tg.maxflow_grid(batch, device="cpu")
    with pytest.raises(ValueError, match=r"\(B, 4, H, W\)"):
        tg.maxflow_grid_batch(single, device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        tg.maxflow_grid_batch(tg.GridProblem(np.zeros((4, 4, 4, 4)),
                                             cs[None], ct[None]),
                              device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        tg.maxflow_grid(tg.GridProblem(cap, cs, ct[:8]), device="cpu")
    with pytest.raises(ValueError, match="unknown maxflow backend 'nope'"):
        tg.maxflow_grid(single, backend="nope", device="cpu")
    with pytest.raises(ValueError, match="balanced"):
        tg.maxflow_grid_batch(batch, backend="nope", device="cpu")
    one_lane = make_solver_mesh(1, device="cpu")
    with pytest.raises(ValueError, match="not in mesh axes"):
        tg.maxflow_grid_batch(batch, mesh=one_lane, mesh_axis="model",
                              device="cpu")
    for compact in (False, True):     # one lane is the solve without one
        assert_same(tg.maxflow_grid_batch(batch, compact=compact,
                                          mesh=one_lane, device="cpu"),
                    tg.maxflow_grid_batch(batch, compact=compact,
                                          device="cpu"))


def test_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cap, cs, ct = _problem("grid16")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tg.maxflow_grid(tg.GridProblem(cap, cs, ct))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tg.maxflow_grid_batch(tg.GridProblem(cap[None], cs[None], ct[None]))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        to_torch((cs,))
    assert resolve_device("cpu") == torch.device("cpu")
