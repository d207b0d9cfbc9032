"""Constants of the JAX package that ``chip_smoke.py`` holds the port to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_smoke_constants.py [rounds|serve]

``chip_smoke.py`` runs where JAX is not installed, so what it compares
with the JAX package is made here, on the CPU, from the same inputs:

* ``rounds`` (a few minutes): the round counts of the assignment and
  matching phases (``ASSIGN_ROUNDS_WANT``, ``MATCH_ROUNDS_WANT``). It
  solves ``chip_smoke.assignment_weights`` and
  ``chip_smoke.matching_adjacency`` one instance at a time (a batch equals
  a loop of single solves, and one instance keeps the memory small),
  checks each answer against its oracle and prints the two constants to
  paste into ``chip_smoke.py``. Counts do not depend on the machine.
* ``serve`` (about a minute, a few GB): the serve phase's reference. It
  loads ``repro_torch.interop.numpy_params(cfg, chip_smoke.SEED)`` into
  the JAX model (smollm-135m at full width), greedily generates
  ``chip_smoke.SERVE_NEW`` tokens for ``chip_smoke.serve_prompts`` the way
  the JAX ``greedy_generate`` does (``jax_generate``), and writes each
  step's top-5 ids, logits and largest |logit| per request
  (``chip_smoke.top5_records``) to ``chip_smoke.SERVE_CONSTANTS``.

With no argument it makes both.
"""
import json
import pathlib
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro.core.assignment.cost_scaling import solve_assignment  # noqa: E402
from repro.core.matching.bfs import match_bipartite  # noqa: E402
from repro.models.layers import Sharder  # noqa: E402
from repro.models.model import apply_model, init_caches  # noqa: E402
from repro_torch.core.assignment.ref import optimal_weight  # noqa: E402
from repro_torch.core.matching.ref import hopcroft_karp  # noqa: E402


def rounds() -> None:
    t0 = time.perf_counter()
    w = chip_smoke.assignment_weights()
    assign = {}
    for method in ("auction", "pushrelabel"):
        counts = []
        for i in range(w.shape[0]):
            res = solve_assignment(jnp.asarray(w[i], jnp.int32),
                                   method=method)
            assert bool(res.converged), (method, i)
            assert int(res.weight) == optimal_weight(w[i]), (method, i)
            counts.append(int(res.rounds))
            print(f"# assignment {method} instance {i}: rounds "
                  f"{counts[-1]}, weight {int(res.weight)} "
                  f"({time.perf_counter() - t0:.0f} s)", flush=True)
        assign[method] = tuple(counts)
    adj = chip_smoke.matching_adjacency()
    match = []
    for i in range(adj.shape[0]):
        res = match_bipartite(jnp.asarray(adj[i]))
        assert bool(res.converged), i
        assert int(res.cardinality) == hopcroft_karp(adj[i])[2], i
        match.append(int(res.rounds))
        print(f"# matching instance {i}: phases {match[-1]}, cardinality "
              f"{int(res.cardinality)} ({time.perf_counter() - t0:.0f} s)",
              flush=True)
    print(f"ASSIGN_ROUNDS_WANT = {assign!r}")
    print(f"MATCH_ROUNDS_WANT = {tuple(match)!r}")


def jax_generate(cfg, params, axes, prompts, max_new: int,
                 S_max: int | None = None):
    """The JAX ``greedy_generate`` (``make_prefill_step``, then
    ``make_serve_step`` with the position from ``lengths[0]``), also
    returning each step's last-position logits. Returns ``(tokens (B,
    max_new), [logits (B, vocab)] * max_new)`` as numpy."""
    shd = Sharder()
    B, S = prompts.shape
    S_max = S_max or (S + max_new + 1)
    caches, _ = init_caches(cfg, B, S_max, dtype=jnp.float32)

    @jax.jit
    def prefill(params, tokens, caches):
        out = apply_model(params, axes, cfg, shd, {"tokens": tokens},
                          caches=caches, logits_mode="last")
        return out.logits[:, -1], out.caches

    @jax.jit
    def step(params, tokens, caches, off):
        out = apply_model(params, axes, cfg, shd, {"tokens": tokens[:, None]},
                          caches=caches, decode=True, pos_offset=off,
                          logits_mode="last")
        return out.logits[:, -1], out.caches

    logits, caches = prefill(params, jnp.asarray(prompts), caches)
    steps = [np.asarray(logits)]
    for i in range(max_new - 1):
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        logits, caches = step(params, nxt, caches, jnp.int32(S + i))
        steps.append(np.asarray(logits))
    tokens = np.stack([np.argmax(lg, axis=-1) for lg in steps], 1)
    return tokens.astype(np.int32), steps


def serve_constants(cfg, *, B: int, S: int, max_new: int, seed: int) -> dict:
    """The JAX package's top-5 records per step for ``numpy_params(cfg,
    seed)`` and ``chip_smoke.serve_prompts(cfg.vocab, B, S)`` (``cfg`` is
    the JAX package's config)."""
    from repro.models.model import init_model

    from repro_torch.interop import numpy_params
    params = jax.tree.map(jnp.asarray, numpy_params(cfg, seed))
    axes = init_model(cfg, jax.random.PRNGKey(0))[1]
    prompts = chip_smoke.serve_prompts(cfg.vocab, B, S)
    tokens, steps = jax_generate(cfg, params, axes, prompts, max_new,
                                 S_max=S + max_new)
    return dict(arch=cfg.name, B=B, S=S, max_new=max_new, seed=seed,
                tokens=tokens.tolist(),
                steps=[chip_smoke.top5_records(lg) for lg in steps])


def serve() -> None:
    from repro.configs.base import get_config
    t0 = time.perf_counter()
    out = serve_constants(get_config(chip_smoke.SERVE_ARCH),
                          B=chip_smoke.SERVE_B, S=chip_smoke.SERVE_S,
                          max_new=chip_smoke.SERVE_NEW, seed=chip_smoke.SEED)
    chip_smoke.SERVE_CONSTANTS.write_text(json.dumps(out) + "\n")
    print(f"# wrote {chip_smoke.SERVE_CONSTANTS.relative_to(ROOT)} "
          f"({time.perf_counter() - t0:.0f} s); request 0 tokens "
          f"{out['tokens'][0]}")


if __name__ == "__main__":
    which = sys.argv[1:] or ["rounds", "serve"]
    for name in which:
        {"rounds": rounds, "serve": serve}[name]()
