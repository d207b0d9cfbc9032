"""Constants of the JAX package that ``chip_smoke.py`` holds the port to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_smoke_constants.py [rounds|serve|moe|deepseek|mamba|train|encoder|kvq]

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
  the routing-stability marks (``routing_marks``): per MoE layer of the
  prefill, per prefill token (``prefill_token_unstable``) and per decode
  step, layer and request.
* ``deepseek`` (about 10 minutes on 8 cores, 35-50 GB resident at its
  peak; run it with nothing else large on the machine): the MLA serve
  phase's reference, made as ``moe``'s for deepseek-v2 at full width cut
  to ``chip_smoke.DS_LAYERS`` layers (``chip_smoke.mla_config``), into
  ``chip_smoke.MLA_CONSTANTS`` and ``chip_smoke.MLA_ROUTING``; the npz
  also holds the hidden state after layer 0 and layer 0's ``c_kv`` and
  ``k_rope`` cache rows at ``chip_smoke.sample_positions`` (recorded from
  inside the jitted prefill).
* ``mamba`` (about 70 s on 8 cores, 3.2 GiB resident at its
  peak): the SSM serve phase's reference. mamba2-370m at full width and
  depth (48 layers), ``numpy_params(cfg, chip_smoke.SEED)``, the serve
  phase's prompts and new tokens: the top-5 records per step to
  ``chip_smoke.SSM_CONSTANTS`` and, to ``chip_smoke.SSM_STATES``, the SSM
  ``state`` and ``conv`` rows of layers ``chip_smoke.SSM_LAYERS`` for the
  first ``chip_smoke.SSM_REQUESTS`` requests after the prefill (the
  caches the jitted prefill returns).

* ``train`` (a few minutes on 8 cores; its peak resident memory is
  printed): the training phase's reference. smollm-135m at full width and
  depth, ``numpy_params(cfg, chip_smoke.SEED)``, and the
  ``chip_smoke.TRAIN_STEPS`` batches of ``TRAIN_B`` x ``TRAIN_S`` tokens
  that the port's ``make_batch`` gives on the card
  (``chip_smoke.TRAIN_ROWS``, written there by
  ``tests/torch_smoke_train_rows.py``: numpy's ``Generator.zipf``, which
  draws the rows of both packages' pipelines, gives other numbers under
  numpy 2.0.2 than under 2.3.5). JAX's ``make_train_step`` with ``Sharder()`` and
  the train CLI's optimizer settings gives each step's loss, lr and
  grad_norm; ``jax.value_and_grad`` of its ``loss_fn`` the step-0
  gradients, of which ``TRAIN_SAMPLE`` seeded flat indices of each leaf
  of ``chip_smoke.TRAIN_LEAVES`` (the leaf's largest |g| among them) and
  that largest |g| go to ``chip_smoke.TRAIN_CONSTANTS``.

* ``encoder`` (about 13 minutes on 8 cores, 19 GiB resident at its
  peak; run it alone): the encoder phase's reference. hubert-xlarge at
  full width and depth, ``numpy_params(cfg, chip_smoke.SEED)``, the JAX
  package's own rows (``rows_batch``, checked equal to the port's) of
  ``chip_smoke.encoder_data``: ``apply_model``'s logits on the
  ``ENC_B`` x ``ENC_S`` forward batch at ``chip_smoke.sample_positions``
  to ``chip_smoke.ENCODER_LOGITS``; JAX's ``make_train_step`` with
  ``Sharder()`` and the config's own ``remat="full"`` on ``ENC_STEPS``
  batches of ``ENC_TRAIN_B`` x ``ENC_S`` frames (loss, lr and grad_norm
  per step), the step-0 gradients of ``chip_smoke.ENCODER_LEAVES``
  sampled as ``train``'s (``embed``'s must be 0) and each batch's
  ``chip_smoke.rows_digest`` to ``chip_smoke.ENCODER_CONSTANTS``.
* ``kvq`` (about 35 s): ``serve``'s reference for smollm-135m with
  ``kv_quant=True`` (the int8 cache), to ``chip_smoke.KVQ_CONSTANTS``.

With no argument it makes all eight.
"""
import dataclasses
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
                 S_max: int | None = None, on_prefill=None):
    """The JAX ``greedy_generate`` (``make_prefill_step``, then
    ``make_serve_step`` with the position from ``lengths[0]``), also
    returning each step's last-position logits. ``on_prefill``, if given,
    is called with the caches the prefill returns. Returns ``(tokens (B,
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
    if on_prefill is not None:
        on_prefill(caches)
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


def routing_marks(scores: np.ndarray, route, rng,
                  perturb: float = chip_smoke.MOE_PERTURB) -> np.ndarray:
    """Per token (all leading axes but the expert one): whether its
    dispatch row changes when ``scores`` move by ``perturb`` x the set's
    largest |score| x N(0, 1), in any of ``chip_smoke.MOE_DRAWS`` draws
    (``route``: scores -> dispatch, numpy)."""
    want = route(scores)
    moved = np.zeros(scores.shape[:-1], bool)
    scale = np.float32(perturb * np.abs(scores).max())
    for _ in range(chip_smoke.MOE_DRAWS):
        z = rng.standard_normal(scores.shape, dtype=np.float32)
        moved |= np.any(route(scores + scale * z) != want, axis=-1)
    return moved


def _record_layer0(rows: dict, positions: np.ndarray):
    """Wrap the JAX ``models.model._apply_sublayer`` so that the first
    prefill sublayer traced (layer 0, the dense prefix) hands its output
    and its cache's two leaves at ``positions`` to the host. Returns a
    function that puts the original back."""
    from repro.models import model as jmodel
    original = jmodel._apply_sublayer
    idx = jnp.asarray(positions)

    def spy(*a, **kw):
        x, cache = original(*a, **kw)
        if not kw["decode"] and "traced" not in rows:
            rows["traced"] = True
            jax.debug.callback(
                lambda h, c, r: rows.update(hidden=np.asarray(h),
                                            c_kv=np.asarray(c),
                                            k_rope=np.asarray(r)),
                x[:, idx], cache.k[:, idx], cache.v[:, idx], ordered=True)
        return x, cache
    jmodel._apply_sublayer = spy
    return lambda: setattr(jmodel, "_apply_sublayer", original)


def _to_jax(tree):
    """A numpy params tree's leaves as JAX arrays, in place, leaf by leaf
    so that numpy and JAX copies never pile up."""
    for k, x in tree.items():
        if isinstance(x, dict):
            _to_jax(x)
        elif isinstance(x, list):
            for sub in x:
                _to_jax(sub)
        else:
            tree[k] = jnp.asarray(x)
    return tree


def _jax_params(cfg):
    """``numpy_params(cfg, chip_smoke.SEED)`` as JAX arrays, and the JAX
    ``init_model``'s logical axes (traced, so no weight is drawn)."""
    from repro.models.model import init_model

    from repro_torch.interop import numpy_params
    params = _to_jax(numpy_params(cfg, chip_smoke.SEED))
    held = {}

    def params_only():
        p, held["axes"] = init_model(cfg, jax.random.PRNGKey(0))
        return p
    jax.eval_shape(params_only)
    return params, held["axes"]


def _routed(cfg, constants: pathlib.Path, routing: pathlib.Path,
            setup: dict, layer0: bool = False) -> None:
    """The reference of a routed serve phase (``moe``, ``deepseek``) for
    ``cfg`` (the JAX package's config, cut to the phase's depth)."""
    from repro.core.routing import auction_route, topk_route
    from repro.models.model import layer_plan
    t0 = time.perf_counter()
    e = cfg.moe
    B, S, new = chip_smoke.SERVE_B, chip_smoke.SERVE_S, chip_smoke.SERVE_NEW
    T = B * S
    moe_layers = np.array([i for i, (_, ffn) in enumerate(layer_plan(cfg))
                           if ffn == "moe"], np.int32)
    L = len(moe_layers)
    cap = min(max(1, int(T * e.top_k / e.n_experts * e.capacity_factor)), T)
    params, axes = _jax_params(cfg)
    print(f"# {cfg.name}, {cfg.n_layers} layers: weights in "
          f"{time.perf_counter() - t0:.0f} s", flush=True)

    seen: list = []
    rows: dict = {}
    restore = [_record_routers(seen)]
    if layer0:
        restore.append(_record_layer0(rows, chip_smoke.sample_positions(S)))
    try:
        prompts = chip_smoke.serve_prompts(cfg.vocab, B, S)
        tokens, steps = jax_generate(cfg, params, axes, prompts, new,
                                     S_max=S + new)
        jax.effects_barrier()
    finally:
        for undo in restore:
            undo()
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

    out = {"capacity": np.int32(cap), "moe_layers": moe_layers,
           "n_layers": np.int32(cfg.n_layers),
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
    perturb = setup["perturb"]
    flips = np.stack([routing_marks(s, auction if router == "auction_route"
                                    else lambda x: topk(x, cap), rng, perturb)
                      for s in out["prefill_scores"]])     # (L, 1, T)
    out["prefill_token_unstable"] = flips.reshape(L, T)
    out["prefill_flips"] = flips.reshape(L, -1).sum(-1).astype(np.int32)
    out["prefill_unstable"] = out["prefill_flips"] > 0
    out["decode_unstable"] = np.stack([
        routing_marks(s, lambda x: topk(x, B), rng, perturb)
        for s in out["decode_scores"].reshape(-1, 1, B, e.n_experts)
    ]).reshape(new - 1, L, B)
    out["skewed_unstable"] = routing_marks(skew, auction, rng, perturb)
    if layer0:
        out["layer0_positions"] = chip_smoke.sample_positions(S)
        out.update({f"layer0_{k}": rows[k]
                    for k in ("hidden", "c_kv", "k_rope")})
    np.savez_compressed(routing, **out)
    constants.write_text(json.dumps(dict(
        setup, tokens=tokens.tolist(),
        steps=[chip_smoke.top5_records(lg) for lg in steps])) + "\n")
    print(f"# wrote {constants.relative_to(ROOT)} and "
          f"{routing.relative_to(ROOT)} "
          f"({time.perf_counter() - t0:.0f} s): capacity {cap}; prefill "
          f"tokens whose dispatch moves per MoE layer "
          f"{out['prefill_flips'].tolist()} (the first: "
          f"{np.flatnonzero(out['prefill_token_unstable'].any(0))[:10].tolist()}"
          f"); largest demand "
          f"{int(out['prefill_auction_demand'].max())}, prices up to "
          f"{float(out['prefill_auction_prices'].max()):.4f}; decode "
          f"(step, layer, request) marks "
          f"{np.argwhere(out['decode_unstable']).tolist()}; skewed set "
          f"{int(out['skewed_unstable'].sum())} tokens, auction prices up "
          f"to {float(out['skewed_auction_prices'].max()):.4f}", flush=True)


def moe() -> None:
    from repro.configs.base import get_config
    _routed(chip_smoke.moe_config(get_config(chip_smoke.MOE_ARCH)),
            chip_smoke.MOE_CONSTANTS, chip_smoke.MOE_ROUTING,
            chip_smoke.moe_setup())


def deepseek() -> None:
    import resource
    from repro.configs.base import get_config
    _routed(chip_smoke.mla_config(get_config(chip_smoke.MLA_ARCH)),
            chip_smoke.MLA_CONSTANTS, chip_smoke.MLA_ROUTING,
            chip_smoke.mla_setup(), layer0=True)
    print(f"# peak resident memory "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.1f}"
          f" GiB", flush=True)


def ssm_rows(cfg, caches) -> dict:
    """The SSM ``state`` and ``conv`` rows of layers ``chip_smoke.SSM_LAYERS``
    for the first ``chip_smoke.SSM_REQUESTS`` requests, from a JAX cache
    tree (``cfg`` the JAX package's config), as float32 numpy arrays
    ``(layers, requests, ...)``."""
    from repro.models.model import plan_period
    period = plan_period(cfg)
    n_pre = cfg.n_dense_prefix
    R = chip_smoke.SSM_REQUESTS
    out = {"state": [], "conv": []}
    for layer in chip_smoke.SSM_LAYERS:
        r, j = divmod(layer - n_pre, period)
        c = caches["prefix"][layer] if layer < n_pre else \
            type(caches["body"][j])(*(x[r] for x in caches["body"][j]))
        for k in out:
            out[k].append(np.asarray(getattr(c, k)[:R], np.float32))
    return {k: np.stack(v) for k, v in out.items()}


def mamba() -> None:
    import resource
    from repro.configs.base import get_config
    t0 = time.perf_counter()
    cfg = get_config(chip_smoke.SSM_ARCH)
    params, axes = _jax_params(cfg)
    print(f"# {cfg.name}, {cfg.n_layers} layers: weights in "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    B, S, new = chip_smoke.SERVE_B, chip_smoke.SERVE_S, chip_smoke.SERVE_NEW
    rows = {}
    tokens, steps = jax_generate(
        cfg, params, axes, chip_smoke.serve_prompts(cfg.vocab, B, S), new,
        S_max=S + new, on_prefill=lambda c: rows.update(ssm_rows(cfg, c)))
    del params
    np.savez_compressed(chip_smoke.SSM_STATES,
                        layers=np.asarray(chip_smoke.SSM_LAYERS, np.int32),
                        **rows)
    chip_smoke.SSM_CONSTANTS.write_text(json.dumps(dict(
        chip_smoke.ssm_setup(), tokens=tokens.tolist(),
        steps=[chip_smoke.top5_records(lg) for lg in steps])) + "\n")
    print(f"# wrote {chip_smoke.SSM_CONSTANTS.relative_to(ROOT)} and "
          f"{chip_smoke.SSM_STATES.relative_to(ROOT)} "
          f"({time.perf_counter() - t0:.0f} s); request 0 tokens "
          f"{tokens[0].tolist()}; peak resident memory "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.1f}"
          f" GiB", flush=True)


def sampled_grads(g, leaves: dict) -> dict:
    """Per leaf of ``leaves`` (``chip_smoke.TRAIN_LEAVES``' layout): its
    JAX shape, ``chip_smoke.TRAIN_SAMPLE`` seeded flat indices and the
    largest |g|'s, the values there and that largest |g|."""
    rng = np.random.default_rng(chip_smoke.SEED)
    grads = {}
    for name, (path, layer) in leaves.items():
        leaf = g
        for key in path:
            leaf = leaf[key]
        leaf = np.asarray(leaf if layer is None else leaf[layer])
        flat = np.abs(leaf.reshape(-1))
        index = np.unique(np.append(rng.choice(
            flat.size, min(chip_smoke.TRAIN_SAMPLE, flat.size),
            replace=False), np.argmax(flat)))
        grads[name] = dict(shape=list(leaf.shape), index=index.tolist(),
                           value=[float(x) for x in
                                  leaf.reshape(-1)[index]],
                           absmax=float(flat.max()))
    return grads


def train() -> None:
    import resource

    from repro.configs.base import get_config
    from repro.optim.adamw import AdamWConfig
    from repro.train.step import (TrainConfig, init_train_state, loss_fn,
                                  make_train_step)
    t0 = time.perf_counter()
    cfg = get_config(chip_smoke.TRAIN_ARCH)
    params, axes = _jax_params(cfg)
    rows = np.load(chip_smoke.TRAIN_ROWS)
    batches = [{k: jnp.asarray(rows[k][step]) for k in ("tokens", "labels")}
               for step in range(chip_smoke.TRAIN_STEPS)]
    print(f"# {cfg.name}, {cfg.n_layers} layers: weights and batches in "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    shd = Sharder()
    grad_fn = jax.jit(jax.grad(lambda p, b: loss_fn(p, axes, cfg, shd, b)[0]))
    g = grad_fn(params, batches[0])
    grads = sampled_grads(g, chip_smoke.TRAIN_LEAVES)
    del g
    print(f"# step-0 gradients ({time.perf_counter() - t0:.0f} s)",
          flush=True)
    tcfg = TrainConfig(optimizer=AdamWConfig(
        lr_peak=chip_smoke.TRAIN_LR, warmup_steps=chip_smoke.TRAIN_WARMUP,
        decay_steps=chip_smoke.TRAIN_STEPS))
    state = init_train_state(cfg, tcfg, params)
    del params
    step_fn = jax.jit(make_train_step(cfg, axes, tcfg, shd),
                      donate_argnums=(0,))
    steps = []
    for step, batch in enumerate(batches):
        state, m = step_fn(state, batch)
        steps.append({k: float(m[k]) for k in ("loss", "lr", "grad_norm")})
        print(f"# step {step}: {steps[-1]} ({time.perf_counter() - t0:.0f} "
              f"s)", flush=True)
    chip_smoke.TRAIN_CONSTANTS.write_text(json.dumps(dict(
        chip_smoke.train_setup(), steps=steps, grads=grads)) + "\n")
    print(f"# wrote {chip_smoke.TRAIN_CONSTANTS.relative_to(ROOT)} "
          f"({time.perf_counter() - t0:.0f} s); peak resident memory "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.1f}"
          f" GiB", flush=True)


def encoder() -> None:
    import resource

    from repro.configs.base import get_config
    from repro.data.pipeline import DataConfig, rows_batch
    from repro.optim.adamw import AdamWConfig
    from repro.train.step import (TrainConfig, init_train_state, loss_fn,
                                  make_train_step)
    from repro_torch.data.pipeline import rows_batch as port_rows_batch
    t0 = time.perf_counter()
    cfg = get_config(chip_smoke.ENCODER_ARCH)
    params, axes = _jax_params(cfg)
    shd = Sharder()

    def rows(global_batch: int, step: int) -> dict:
        dcfg = chip_smoke.encoder_data(global_batch)
        out = rows_batch(DataConfig(**dataclasses.asdict(dcfg)), step, 0,
                         global_batch)
        ours = port_rows_batch(dcfg, step, 0, global_batch)
        assert all(np.array_equal(out[k], ours[k]) for k in out)
        return out
    fwd = rows(chip_smoke.ENC_B, 0)
    batches = [rows(chip_smoke.ENC_TRAIN_B, step)
               for step in range(chip_smoke.ENC_STEPS)]
    print(f"# {cfg.name}, {cfg.n_layers} layers, remat {cfg.remat}: "
          f"weights and rows in {time.perf_counter() - t0:.0f} s",
          flush=True)
    positions = jnp.asarray(chip_smoke.sample_positions(chip_smoke.ENC_S))
    forward = jax.jit(lambda p, e: apply_model(
        p, axes, cfg, shd, {"embeds": e}).logits[:, positions])
    logits = np.asarray(forward(params, jnp.asarray(fwd["embeds"])))
    print(f"# forward of {fwd['embeds'].shape} frames "
          f"({time.perf_counter() - t0:.0f} s)", flush=True)
    jb = [{k: jnp.asarray(x) for k, x in b.items()} for b in batches]
    grad_fn = jax.jit(jax.grad(lambda p, b: loss_fn(p, axes, cfg, shd, b)[0]))
    g = grad_fn(params, jb[0])
    assert not np.asarray(g["embed"]).any(), "embed has a gradient"
    grads = sampled_grads(g, chip_smoke.ENCODER_LEAVES)
    del g
    print(f"# step-0 gradients ({time.perf_counter() - t0:.0f} s)",
          flush=True)
    tcfg = TrainConfig(optimizer=AdamWConfig(
        lr_peak=chip_smoke.TRAIN_LR, warmup_steps=chip_smoke.TRAIN_WARMUP,
        decay_steps=chip_smoke.ENC_STEPS))
    state = init_train_state(cfg, tcfg, params)
    del params
    step_fn = jax.jit(make_train_step(cfg, axes, tcfg, shd),
                      donate_argnums=(0,))
    steps = []
    for step, batch in enumerate(jb):
        state, m = step_fn(state, batch)
        steps.append({k: float(m[k]) for k in ("loss", "lr", "grad_norm")})
        print(f"# step {step}: {steps[-1]} ({time.perf_counter() - t0:.0f} "
              f"s)", flush=True)
    del state
    np.savez_compressed(chip_smoke.ENCODER_LOGITS, logits=logits)
    chip_smoke.ENCODER_CONSTANTS.write_text(json.dumps(dict(
        chip_smoke.encoder_setup(), steps=steps, grads=grads,
        rows={"forward": chip_smoke.rows_digest(fwd),
              "train": [chip_smoke.rows_digest(b) for b in batches]},
        numpy_version=np.__version__)) + "\n")
    print(f"# wrote {chip_smoke.ENCODER_CONSTANTS.relative_to(ROOT)} and "
          f"{chip_smoke.ENCODER_LOGITS.relative_to(ROOT)} "
          f"({time.perf_counter() - t0:.0f} s); peak resident memory "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.1f}"
          f" GiB", flush=True)


def kvq() -> None:
    from repro.configs.base import get_config
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(chip_smoke.SERVE_ARCH),
                              kv_quant=True)
    out = serve_constants(cfg, B=chip_smoke.SERVE_B, S=chip_smoke.SERVE_S,
                          max_new=chip_smoke.SERVE_NEW, seed=chip_smoke.SEED)
    chip_smoke.KVQ_CONSTANTS.write_text(json.dumps(dict(
        out, **chip_smoke.kvq_setup())) + "\n")
    print(f"# wrote {chip_smoke.KVQ_CONSTANTS.relative_to(ROOT)} "
          f"({time.perf_counter() - t0:.0f} s); request 0 tokens "
          f"{out['tokens'][0]}", flush=True)


if __name__ == "__main__":
    which = sys.argv[1:] or ["rounds", "serve", "moe", "deepseek", "mamba",
                             "train", "encoder", "kvq"]
    for name in which:
        {"rounds": rounds, "serve": serve, "moe": moe,
         "deepseek": deepseek, "mamba": mamba, "train": train,
         "encoder": encoder, "kvq": kvq}[name]()
