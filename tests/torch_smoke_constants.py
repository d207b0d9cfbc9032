"""Constants of the JAX package that ``chip_smoke.py`` holds the port to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_smoke_constants.py [rounds|serve|moe]

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
* ``moe`` (about 3 minutes on 8 cores, 29 GB resident at its peak): the
  MoE serve phase's reference. phi3.5-moe at full width cut to
  ``chip_smoke.MOE_LAYERS`` layers (``chip_smoke.moe_config``), weights
  ``numpy_params(cfg, chip_smoke.SEED)``, the serve phase's prompts and
  new tokens. It writes the top-5 records per step to
  ``chip_smoke.MOE_CONSTANTS`` and, to ``chip_smoke.MOE_ROUTING``, every
  MoE layer's gate logits and dispatch in the prefill and in each decode
  step (recorded from inside the jitted model), the auction's and top-k's
  routing of the prefill logits and of a seeded skewed score set, and
  the routing-stability marks (``routing_marks``).

With no argument it makes all three.
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


def _record_routers(seen: list):
    """Wrap the JAX ``models.mlp`` routers so that every call inside the
    jitted model hands its scores and dispatch to the host, in order.
    Returns a function that puts the originals back."""
    from repro.models import mlp
    originals = {n: getattr(mlp, n) for n in ("auction_route", "topk_route")}

    def spy(name):
        def route(scores, k, capacity, **kw):
            r = originals[name](scores, k, capacity, **kw)
            jax.debug.callback(
                lambda s, d: seen.append((name, capacity, np.asarray(s),
                                          np.asarray(d))),
                scores, r.dispatch, ordered=True)
            return r
        return route
    for name in originals:
        setattr(mlp, name, spy(name))
    return lambda: [setattr(mlp, n, f) for n, f in originals.items()]


def _routing_arrays(prefix: str, r) -> dict:
    """A JAX ``Routing`` as npz arrays, ``{prefix}_{field}``."""
    return {f"{prefix}_{k}": np.asarray(x) for k, x in r._asdict().items()}


def routing_marks(scores: np.ndarray, route, rng) -> np.ndarray:
    """Per token (all leading axes but the expert one): whether its
    dispatch row changes when ``scores`` move by
    ``chip_smoke.MOE_PERTURB`` x the set's largest |score| x N(0, 1), in
    any of ``chip_smoke.MOE_DRAWS`` draws (``route``: scores -> dispatch,
    numpy)."""
    want = route(scores)
    moved = np.zeros(scores.shape[:-1], bool)
    scale = np.float32(chip_smoke.MOE_PERTURB * np.abs(scores).max())
    for _ in range(chip_smoke.MOE_DRAWS):
        z = rng.standard_normal(scores.shape, dtype=np.float32)
        moved |= np.any(route(scores + scale * z) != want, axis=-1)
    return moved


def moe() -> None:
    from repro.configs.base import get_config
    from repro.core.routing import auction_route, topk_route
    from repro.models.model import init_model

    from repro_torch.interop import numpy_params
    t0 = time.perf_counter()
    cfg = chip_smoke.moe_config(get_config(chip_smoke.MOE_ARCH))
    e = cfg.moe
    B, S, new = chip_smoke.SERVE_B, chip_smoke.SERVE_S, chip_smoke.SERVE_NEW
    T, L = B * S, cfg.n_layers
    cap = min(max(1, int(T * e.top_k / e.n_experts * e.capacity_factor)), T)
    params = numpy_params(cfg, chip_smoke.SEED)

    def to_jax(tree):     # leaf by leaf, so numpy and JAX copies never pile up
        for k, x in tree.items():
            if isinstance(x, dict):
                to_jax(x)
            elif isinstance(x, list):
                for sub in x:
                    to_jax(sub)
            else:
                tree[k] = jnp.asarray(x)
        return tree
    params = to_jax(params)
    held = {}

    def params_only():          # traced, so no weight is drawn
        p, held["axes"] = init_model(cfg, jax.random.PRNGKey(0))
        return p
    jax.eval_shape(params_only)
    axes = held["axes"]
    print(f"# {cfg.name}, {L} layers: weights in "
          f"{time.perf_counter() - t0:.0f} s", flush=True)

    seen: list = []
    restore = _record_routers(seen)
    try:
        prompts = chip_smoke.serve_prompts(cfg.vocab, B, S)
        tokens, steps = jax_generate(cfg, params, axes, prompts, new,
                                     S_max=S + new)
        jax.effects_barrier()
    finally:
        restore()
    del params
    print(f"# generated ({time.perf_counter() - t0:.0f} s); request 0 "
          f"tokens {tokens[0].tolist()}", flush=True)
    router = "auction_route" if e.router == "flow" else "topk_route"
    pre, dec = seen[:L], seen[L:]
    assert [n for n, *_ in pre] == [router] * L, [n for n, *_ in pre]
    assert [(n, c) for n, c, *_ in dec] == [("topk_route", B)] * (L * (new - 1))
    rng = np.random.default_rng(chip_smoke.SEED + 4)

    def auction(s):
        return np.asarray(auction_route(jnp.asarray(s), e.top_k, cap,
                                        n_iters=e.router_iters).dispatch)

    def topk(s, c):
        return np.asarray(topk_route(jnp.asarray(s), e.top_k, c).dispatch)

    out = {"capacity": np.int32(cap),
           "prefill_scores": np.stack([s for _, _, s, _ in pre]),
           "prefill_dispatch": np.stack([d for *_, d in pre]),
           "decode_scores": np.stack([s for _, _, s, _ in dec]).reshape(
               new - 1, L, 1, B, e.n_experts),
           "decode_dispatch": np.stack([d for *_, d in dec]).reshape(
               new - 1, L, 1, B, e.n_experts)}
    skew = chip_smoke.moe_skewed_scores(T, e.n_experts)
    out["skewed_scores"] = skew
    for name, s in (("prefill", out["prefill_scores"]), ("skewed", skew)):
        out.update(_routing_arrays(f"{name}_auction", auction_route(
            jnp.asarray(s), e.top_k, cap, n_iters=e.router_iters)))
        out.update(_routing_arrays(f"{name}_topk", topk_route(
            jnp.asarray(s), e.top_k, cap)))
    # the routing inside the jitted model is the eager router's
    assert np.array_equal(out[f"prefill_{router.split('_')[0]}_dispatch"],
                          out["prefill_dispatch"])
    flips = np.stack([routing_marks(s, auction if router == "auction_route"
                                    else lambda x: topk(x, cap), rng)
                      for s in out["prefill_scores"]])     # (L, 1, T)
    out["prefill_flips"] = flips.reshape(L, -1).sum(-1).astype(np.int32)
    out["prefill_unstable"] = out["prefill_flips"] > 0
    out["decode_unstable"] = np.stack([
        routing_marks(s, lambda x: topk(x, B), rng)
        for s in out["decode_scores"].reshape(-1, 1, B, e.n_experts)
    ]).reshape(new - 1, L, B)
    out["skewed_unstable"] = routing_marks(skew, auction, rng)
    np.savez_compressed(chip_smoke.MOE_ROUTING, **out)
    setup = chip_smoke.moe_setup()
    chip_smoke.MOE_CONSTANTS.write_text(json.dumps(dict(
        setup, tokens=tokens.tolist(),
        steps=[chip_smoke.top5_records(lg) for lg in steps])) + "\n")
    print(f"# wrote {chip_smoke.MOE_CONSTANTS.relative_to(ROOT)} and "
          f"{chip_smoke.MOE_ROUTING.relative_to(ROOT)} "
          f"({time.perf_counter() - t0:.0f} s): capacity {cap}; prefill "
          f"tokens whose dispatch moves per layer "
          f"{out['prefill_flips'].tolist()}; decode (step, layer, request) "
          f"marks {np.argwhere(out['decode_unstable']).tolist()}; skewed "
          f"set {int(out['skewed_unstable'].sum())} tokens, auction prices "
          f"up to {float(out['skewed_auction_prices'].max()):.4f}",
          flush=True)


if __name__ == "__main__":
    which = sys.argv[1:] or ["rounds", "serve", "moe"]
    for name in which:
        {"rounds": rounds, "serve": serve, "moe": moe}[name]()
