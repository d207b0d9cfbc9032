"""The port's configs, layers, dense GQA, MLA and MoE models against the
JAX package.

Configs are pure data and must be equal. Weights cross from the JAX
layout (``repro_torch.interop``): the same ``numpy_params`` tree goes into
the JAX ``apply_model`` (with ``Sharder()``, no mesh) and the port's. Both
run float32 on the CPU and differ only in summation order, which at smoke
size moves logits by about 1e-6 of their largest magnitude. Tolerance:
``LOGIT_TOL`` x the largest |logit| (absolute), ``1e-5`` for the
building blocks. The MoE layer is held to ``MOE_TOL`` x its largest
|output|, and its routers' dispatch to the JAX package's exactly; the MLA
layer (outputs and its ``c_kv`` / ``k_rope`` cache) to ``MLA_TOL`` x each
leaf's largest |value|. Caches are compared field by field over the
layers of one mixer kind (``k`` / ``v`` of attention, ``state`` / ``conv``
of mamba), at ``LOGIT_TOL`` x the field's largest |value|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import list_configs as jax_list_configs
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models.layers import Sharder
from repro_torch.configs.base import get_config, list_configs, smoke_variant
from repro_torch.interop import load_params, model_from_params, numpy_params
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro.models import attention as jattn
from repro.models import mlp as jmlp
from repro_torch.core.routing import auction_route, topk_route
from repro_torch.models import mlp as tmlp
from repro_torch.models.attention import (GQA, MLA, KVCache, KVCacheQ,
                                         init_mla, mla_apply)
from repro_torch.models.mamba import Mamba, SSMCache
from repro_torch.models.mlp import MLP, MoE, init_moe, moe_apply

LOGIT_TOL = 1e-5
BLOCK_TOL = 1e-5
MOE_TOL = 1e-5
MLA_TOL = 1e-5
PHI = "phi3.5-moe-42b-a6.6b"
DEEPSEEK = "deepseek-v2-236b"
MAMBA = "mamba2-370m"
JAMBA = "jamba-v0.1-52b"
HUBERT = "hubert-xlarge"
RUNNABLE = ["chameleon-34b", "command-r-plus-104b", DEEPSEEK, HUBERT, JAMBA,
            MAMBA, "minitron-8b", "nemotron-4-340b", PHI, "smollm-135m"]
# the archs with a decode path: every one but the encoder
DECODERS = [a for a in RUNNABLE if a != HUBERT]


def _cfgs(arch):
    return (smoke_variant(get_config(arch)),
            jax_smoke_variant(jax_get_config(arch)))


def _axes(jcfg):
    return jmodel.init_model(jcfg, jax.random.PRNGKey(0))[1]


def _close(got, want, what=""):
    want = np.asarray(want)
    tol = LOGIT_TOL * np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# Configs and plans
# ---------------------------------------------------------------------------

def test_registry_equals_jax():
    assert list_configs() == jax_list_configs()
    assert sorted(RUNNABLE) == list_configs()


@pytest.mark.parametrize("arch", sorted(RUNNABLE))
def test_config_and_plan_equal_jax(arch):
    cfg, jcfg = _cfgs(arch)
    full, jfull = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert full.param_count() == jfull.param_count()
    assert full.active_param_count() == jfull.active_param_count()
    for a, b in ((cfg, jcfg), (full, jfull)):
        assert tmodel.layer_plan(a) == jmodel.layer_plan(b)
        assert tmodel.plan_period(a) == jmodel.plan_period(b)


@pytest.mark.parametrize("arch", sorted([HUBERT, PHI, DEEPSEEK, JAMBA,
                                         MAMBA]))
def test_unported_family_raises(arch):
    """The families ported after the dense one build and get the JAX
    params tree: hubert-xlarge (the encoder: a ``frontend`` projection,
    non-causal MHA ``GQA`` without RoPE, LayerNorm with biases, a GELU
    ``MLP``), phi3.5-moe and deepseek-v2 (MoE layers; MLA mixers after a
    dense prefix), mamba2 (a ``Mamba`` mixer in every layer, no FFN) and
    jamba (attention at every ``attn_period``-th layer, mamba elsewhere,
    the MoE at every other layer, an ``MLP`` between). No family
    raises any more."""
    cfg, jcfg = _cfgs(arch)
    model = tmodel.init_model(cfg, torch.Generator(), device="cpu")
    n_pre = cfg.n_dense_prefix
    if arch == HUBERT:
        assert not cfg.causal and not cfg.rope_theta
        assert tuple(model.frontend.weight.shape) == (cfg.d_model,
                                                      cfg.frontend_dim)
        assert model.frontend.bias is None
        assert all(isinstance(b.mixer, GQA) and isinstance(b.ffn, MLP)
                   and b.norm1.kind == b.norm2.kind == "layernorm"
                   and hasattr(b.norm1, "b") for b in model.layers)
        assert cfg.n_kv_heads == cfg.n_heads and not cfg.gated_mlp
        assert hasattr(model.final_norm, "b") and hasattr(model, "lm_head")
    elif arch in (PHI, DEEPSEEK):
        assert all(isinstance(b.ffn, MoE) for b in model.layers[n_pre:])
        assert all(isinstance(b.ffn, MLP) for b in model.layers[:n_pre])
        assert all(isinstance(b.mixer, MLA) == (arch == DEEPSEEK)
                   for b in model.layers)
    elif arch == MAMBA:
        assert all(isinstance(b.mixer, Mamba) and not hasattr(b, "ffn")
                   for b in model.layers)
    else:
        for i, b in enumerate(model.layers):
            attn = i % cfg.attn_period == 0
            assert isinstance(b.mixer, GQA if attn else Mamba), i
            assert isinstance(b.ffn, MoE if i % 2 == 0 else MLP), i
    assert [("mamba" if isinstance(b.mixer, Mamba) else "attn",
             "moe" if isinstance(getattr(b, "ffn", None), MoE)
             else "mlp" if hasattr(b, "ffn") else None)
            for b in model.layers] == jmodel.layer_plan(jcfg)
    theirs = jmodel.init_model(jcfg, jax.random.PRNGKey(0))[0]
    assert (jax.tree.structure(numpy_params(cfg))
            == jax.tree.structure(theirs))


def test_unported_pieces_raise():
    """Nothing the reference runs raises any more: ``kv_quant=True``
    builds ``KVCacheQ`` caches (int8 codes, float32 scales) that a prefill
    fills and a decode step extends; ``init_mla`` and ``mla_apply`` build
    an MLA layer and run it (prefill into a cache, then a decode step)."""
    cfg = dataclasses.replace(_cfgs("smollm-135m")[0], kv_quant=True)
    model = tmodel.init_model(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    caches = tmodel.init_caches(cfg, 2, 8, dtype=torch.float32, device="cpu")
    assert all(isinstance(c, KVCacheQ) for c in caches)
    assert caches[0].k_q.dtype == caches[0].v_q.dtype == torch.int8
    assert caches[0].k_s.dtype == caches[0].v_s.dtype == torch.float32
    assert tuple(caches[0].k_s.shape) == (2, 8, cfg.n_kv_heads, 1)
    toks = torch.randint(0, cfg.vocab, (2, 7), generator=torch.Generator())
    with torch.no_grad():
        pre = tmodel.apply_model(model, {"tokens": toks[:, :6]},
                                 caches=caches)
        dec = tmodel.apply_model(model, {"tokens": toks[:, 6:]},
                                 caches=pre.caches, decode=True,
                                 pos_offset=6)
    assert all(int(c.length) == 7 for c in dec.caches)
    assert bool(dec.caches[0].k_q[:, :7].abs().amax(-1).eq(127).all())
    assert torch.isfinite(dec.logits).all()
    cfg = _cfgs(DEEPSEEK)[0]
    p = init_mla(MLA(cfg, device="cpu"), torch.Generator().manual_seed(0))
    cache = tmodel.init_caches(cfg, 2, 8, dtype=torch.float32,
                               device="cpu")[0]
    x = torch.randn(2, 7, cfg.d_model, generator=torch.Generator())
    with torch.no_grad():
        out, cache = mla_apply(p, x[:, :6], cfg, positions=torch.arange(6),
                               cache=cache, decode=False)
        step, cache = mla_apply(p, x[:, 6:], cfg,
                                positions=torch.tensor([6]), cache=cache,
                                decode=True)
    assert out.shape == (2, 6, cfg.d_model) and step.shape == (2, 1,
                                                               cfg.d_model)
    assert int(cache.length) == 7 and torch.isfinite(out).all()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg, _ = _cfgs("smollm-135m")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodel.init_model(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodel.init_caches(cfg, 1, 8)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def test_norms_and_activations_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3
    g = rng.normal(size=48).astype(np.float32)
    b = rng.normal(size=48).astype(np.float32)
    tx, tg, tb = (torch.tensor(a) for a in (x, g, b))
    np.testing.assert_allclose(tlayers.rmsnorm(tx, tg).numpy(),
                               np.asarray(jlayers.rmsnorm(x, g)),
                               rtol=BLOCK_TOL, atol=BLOCK_TOL)
    np.testing.assert_allclose(tlayers.layernorm(tx, tg, tb).numpy(),
                               np.asarray(jlayers.layernorm(x, g, b)),
                               rtol=BLOCK_TOL, atol=BLOCK_TOL)
    assert sorted(tlayers.ACTIVATIONS) == sorted(jlayers.ACTIVATIONS)
    for name, fn in tlayers.ACTIVATIONS.items():
        np.testing.assert_allclose(
            fn(tx).numpy(), np.asarray(jlayers.ACTIVATIONS[name](x)),
            rtol=BLOCK_TOL, atol=BLOCK_TOL, err_msg=name)


@pytest.mark.parametrize("theta,offset", [(10_000.0, 0), (75_000_000.0, 37)])
def test_rope_matches_jax(theta, offset):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 12, 3, 32)).astype(np.float32)
    pos = offset + np.arange(12)
    got = tlayers.apply_rope(torch.tensor(x), torch.tensor(pos), theta)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=BLOCK_TOL, atol=BLOCK_TOL)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("arch", RUNNABLE)
def test_numpy_params_is_the_jax_tree(arch):
    """Same structure, shapes and dtypes as the JAX ``init_model``; each
    large leaf's spread within 10% of JAX's (the same std, other draws)."""
    cfg, jcfg = _cfgs(arch)
    ours = numpy_params(cfg, seed=0)
    theirs = jmodel.init_model(jcfg, jax.random.PRNGKey(0))[0]
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    for (path, a), (_, b) in zip(_leaves(ours), _leaves(theirs)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.size >= 4096:
            assert abs(np.std(a) / np.std(np.asarray(b)) - 1) < 0.1, path
        elif np.all(np.asarray(b) == np.asarray(b).flat[0]):
            assert np.array_equal(a, np.asarray(b)), path     # ones, zeros


@pytest.mark.parametrize("arch", RUNNABLE)
def test_init_model_shapes_and_stds_match_jax(arch):
    """The port's own init: every tensor takes the JAX init's tree (checked
    by ``load_state_dict(strict=True)``), with spreads within 10%."""
    cfg, jcfg = _cfgs(arch)
    model = tmodel.init_model(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    theirs = jmodel.init_model(jcfg, jax.random.PRNGKey(0))[0]
    mirror = load_params(tmodel.Model(cfg, device="cpu"), theirs)
    ours, ref = model.state_dict(), mirror.state_dict()
    assert ours.keys() == ref.keys()
    for name, t in ours.items():
        assert t.shape == ref[name].shape and t.dtype == ref[name].dtype
        if t.numel() >= 4096:
            assert abs(t.std().item() / ref[name].std().item() - 1) < 0.1, \
                name
        elif torch.all(ref[name] == ref[name].flatten()[0]):
            assert torch.equal(t, ref[name]), name      # ones, zeros
        else:       # a small random tensor (an MoE gate): its spread
            assert abs(t.std().item() / ref[name].std().item() - 1) < 0.25, \
                name


# ---------------------------------------------------------------------------
# Forward: prefill and a decode step
# ---------------------------------------------------------------------------

def _setup(arch, B=2, S=16):
    cfg, jcfg = _cfgs(arch)
    params = numpy_params(cfg, seed=0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S),
                                             dtype=np.int32)
    return cfg, jcfg, params, model_from_params(cfg, params, "cpu"), toks


def _inputs(cfg, toks):
    """The model's input for ``toks``' shape: the tokens, or for a config
    with a frontend seeded frame embeddings ``(B, S, frontend_dim)``."""
    if not cfg.frontend_dim:
        return {"tokens": toks}
    return {"embeds": np.random.default_rng(1).standard_normal(
        toks.shape + (cfg.frontend_dim,), dtype=np.float32)}


@pytest.mark.parametrize("mode", ["all", "last"])
@pytest.mark.parametrize("arch", RUNNABLE)
def test_apply_model_matches_jax(arch, mode):
    cfg, jcfg, params, model, toks = _setup(arch)
    batch = _inputs(cfg, toks)
    want = jmodel.apply_model(params, _axes(jcfg), jcfg, Sharder(),
                              {k: jnp.asarray(x) for k, x in batch.items()},
                              logits_mode=mode)
    with torch.no_grad():
        got = tmodel.apply_model(model, {k: torch.tensor(x)
                                         for k, x in batch.items()},
                                 logits_mode=mode)
    assert got.caches is None and want.caches is None
    assert tuple(got.logits.shape) == want.logits.shape
    _close(got.logits.numpy(), want.logits, arch)


def _jax_layer_caches(jcfg, caches):
    """A JAX cache tree as one cache per layer, numpy leaves, in the
    port's layer order (``prefix`` first, then ``body["sub{j}"]`` at each
    period)."""
    period = jmodel.plan_period(jcfg)
    n_periods = (jcfg.n_layers - jcfg.n_dense_prefix) // period
    out = [type(c)(*(np.asarray(x) for x in c)) for c in caches["prefix"]]
    out += [type(c)(*(np.asarray(x)[r] for x in c))
            for r in range(n_periods) for c in caches["body"]]
    return out


_CACHE_FIELDS = {KVCache: ("k", "v"), SSMCache: ("state", "conv")}


def _caches_close(got, want, what, length):
    """The port's caches against JAX's (``_jax_layer_caches``): the same
    kind per layer, each field stacked over the layers of that kind within
    ``LOGIT_TOL`` x its largest |value|, every ``length`` ``length``."""
    assert [type(c).__name__ for c in got] == \
        [type(c).__name__ for c in want], what
    for kind, fields in _CACHE_FIELDS.items():
        idx = [i for i, c in enumerate(got) if isinstance(c, kind)]
        for field in fields if idx else ():
            _close(np.stack([getattr(got[i], field).numpy() for i in idx]),
                   np.stack([getattr(want[i], field) for i in idx]),
                   f"{what} {field}")
    assert all(int(c.length) == length for c in got), what
    assert all(int(c.length) == length for c in want), what
    assert all(c.state.dtype == torch.float32 for c in got
               if isinstance(c, SSMCache))


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_then_decode_step_match_jax(arch):
    """Prefill S - 1 tokens into S + 4 caches, then decode the last one:
    the caches (``k`` / ``v`` of attention layers, ``state`` / ``conv`` of
    mamba layers, every ``length``) and both steps' logits as in JAX."""
    cfg, jcfg, params, model, toks = _setup(arch)
    B, S = toks.shape
    axes, shd = _axes(jcfg), Sharder()
    jc, _ = jmodel.init_caches(jcfg, B, S + 4, dtype=jnp.float32)
    jpre = jmodel.apply_model(params, axes, jcfg, shd,
                              {"tokens": jnp.asarray(toks[:, :-1])},
                              caches=jc)
    jdec = jmodel.apply_model(params, axes, jcfg, shd,
                              {"tokens": jnp.asarray(toks[:, -1:])},
                              caches=jpre.caches, decode=True,
                              pos_offset=S - 1)
    tc = tmodel.init_caches(cfg, B, S + 4, dtype=torch.float32,
                            device="cpu")
    with torch.no_grad():
        pre = tmodel.apply_model(model, {"tokens": torch.tensor(
            toks[:, :-1])}, caches=tc)
        _close(pre.logits.numpy(), jpre.logits, "prefill")
        _caches_close(pre.caches, _jax_layer_caches(jcfg, jpre.caches),
                      "prefill", S - 1)
        dec = tmodel.apply_model(
            model, {"tokens": torch.tensor(toks[:, -1:])}, caches=pre.caches,
            decode=True, pos_offset=torch.tensor(S - 1))
    _close(dec.logits.numpy(), jdec.logits, "decode")
    assert all(isinstance(c, (KVCache, SSMCache)) for c in dec.caches)
    _caches_close(dec.caches, _jax_layer_caches(jcfg, jdec.caches), "decode",
                  S)


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------

def _pairs(tree):
    """A params tree as the JAX modules take it: ``(array,)`` leaves
    (``p["w1"][0]``)."""
    if isinstance(tree, dict):
        return {k: _pairs(x) for k, x in tree.items()}
    return (jnp.asarray(tree),)


def _moe_case(router, cf, n_shared):
    cfg, jcfg = _cfgs(PHI)
    moe = dataclasses.replace(cfg.moe, router=router, capacity_factor=cf,
                              n_shared=n_shared)
    cfg = dataclasses.replace(cfg, moe=moe)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, **dataclasses.asdict(moe)))
    params = numpy_params(cfg, seed=3)
    tree = {k: x[0] if not isinstance(x, dict)
            else {kk: xx[0] for kk, xx in x.items()}
            for k, x in params["body"]["sub0"]["ffn"].items()}
    layer = tmodel.Model(cfg, device="cpu")
    load_params(layer, params)
    return cfg, jcfg, tree, layer.layers[0].ffn


@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("cf", [2.5, 1.0])
@pytest.mark.parametrize("router", ["flow", "topk"])
def test_moe_apply_matches_jax(router, cf, decode, n_shared):
    """``moe_apply`` against the JAX ``moe_apply`` on the same layer
    weights and inputs, and the router each runs (auction for flow in
    prefill, top-k otherwise, at the same capacity) with equal dispatch.
    Capacity factor 1.0 makes the auction raise prices at this size;
    the smoke variant's 2.5 gives capacity >= T."""
    cfg, jcfg, tree, moe = _moe_case(router, cf, n_shared)
    x = np.random.default_rng(4).normal(size=(2, 16, cfg.d_model)).astype(
        np.float32)
    want = jmlp.moe_apply(_pairs(tree), jnp.asarray(x), jcfg, Sharder(),
                          decode=decode)
    with torch.no_grad():
        got = moe_apply(moe, torch.tensor(x), cfg, decode=decode)
        logits = moe.gate(torch.tensor(x).reshape(1, 32, -1)).float()
    jlogits = (jnp.asarray(x).reshape(1, 32, -1) @ tree["gate"]).astype(
        jnp.float32)
    T, E, k = 32, cfg.moe.n_experts, cfg.moe.top_k
    cap = tmlp.moe_capacity(cfg, T, decode)
    assert cap == (T if decode else min(int(T * k / E * cf), T))
    if router == "flow" and not decode:
        r = auction_route(logits, k, cap, n_iters=cfg.moe.router_iters)
        jrt = jmlp.auction_route(jlogits, k, cap,
                                 n_iters=cfg.moe.router_iters)
        assert bool(r.prices.any()) == (cf == 1.0)   # prices engaged
    else:
        r, jrt = topk_route(logits, k, cap), jmlp.topk_route(jlogits, k, cap)
    assert np.array_equal(r.dispatch.numpy(), np.asarray(jrt.dispatch))
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=MOE_TOL * np.abs(want).max())


def test_moe_aux_metrics_match_jax():
    cfg, jcfg, tree, moe = _moe_case("flow", 1.0, 0)
    x = np.random.default_rng(5).normal(size=(2, 16, cfg.d_model)).astype(
        np.float32)
    want = jmlp.moe_aux_metrics(_pairs(tree), jnp.asarray(x), jcfg)
    with torch.no_grad():
        got = tmlp.moe_aux_metrics(moe, torch.tensor(x), cfg)
    assert int(got["max_load"]) == int(want["max_load"])
    assert int(got["routed"]) == int(want["routed"])
    np.testing.assert_allclose(float(got["load_cv"]), float(want["load_cv"]),
                               rtol=1e-5)


def test_moe_drops_past_capacity_and_keeps_the_rest():
    """At capacity 1 per expert most of the tokens' picks are dropped, and
    a dropped token's output is exactly 0 (JAX's too)."""
    cfg, jcfg, tree, moe = _moe_case("topk", 0.1, 0)
    x = np.random.default_rng(6).normal(size=(1, 32, cfg.d_model)).astype(
        np.float32)
    assert tmlp.moe_capacity(cfg, 32, False) == 1
    want = np.asarray(jmlp.moe_apply(_pairs(tree), jnp.asarray(x), jcfg,
                                     Sharder()))
    with torch.no_grad():
        got = moe_apply(moe, torch.tensor(x), cfg).numpy()
    zero = np.all(want == 0, axis=-1)
    assert zero.sum() >= 32 - cfg.moe.n_experts
    assert np.array_equal(np.all(got == 0, axis=-1), zero)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=MOE_TOL * np.abs(want).max())


# ---------------------------------------------------------------------------
# MLA and the dense prefix
# ---------------------------------------------------------------------------

def _mla_case(seed=5):
    """deepseek's smoke variant, its layer-0 MLA from ``numpy_params``: the
    JAX tree of that mixer, and the port's ``MLA`` holding it."""
    cfg, jcfg = _cfgs(DEEPSEEK)
    params = numpy_params(cfg, seed=seed)
    model = model_from_params(cfg, params, "cpu")
    return cfg, jcfg, params["prefix"][0]["mixer"], model.layers[0].mixer


def _mla_cache(cfg, rng, B, T, length):
    m = cfg.mla
    return (rng.normal(size=(B, T, m.kv_lora_rank)).astype(np.float32),
            rng.normal(size=(B, T, m.qk_rope_dim)).astype(np.float32),
            np.int32(length))


def _mla_both(cfg, jcfg, tree, mla, x, pos, cache, decode):
    """The JAX ``mla_apply`` and the port's on the same inputs (the port
    on its own copy of the cache, which it writes in place)."""
    want = jattn.mla_apply(_pairs(tree), jnp.asarray(x), jcfg, Sharder(),
                           positions=jnp.asarray(pos),
                           cache=None if cache is None else jattn.KVCache(
                               *(jnp.asarray(c) for c in cache)),
                           decode=decode)
    tc = None if cache is None else KVCache(
        *(torch.tensor(np.array(c)) for c in cache))
    with torch.no_grad():
        got = mla_apply(mla, torch.tensor(x), cfg,
                        positions=torch.tensor(pos), cache=tc, decode=decode)
    return got, want


def _mla_close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=MLA_TOL * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("mode", ["prefill", "prefill into a cache",
                                  "decode at 0", "decode at 9",
                                  "decode at 23", "decode clamped at S_max"])
def test_mla_apply_matches_jax(mode):
    """``mla_apply`` against the JAX ``mla_apply`` on the same weights and
    inputs: prefill (expanded K/V through the plain scan) with and without
    a cache of ``S_max`` 24, and the absorbed decode at several cache
    lengths, up to a full cache, whose write both clamp to ``S_max - 1``.
    Outputs, ``c_kv``, ``k_rope`` and ``length`` leaf for leaf."""
    cfg, jcfg, tree, mla = _mla_case()
    rng = np.random.default_rng(6)
    B, T = 2, 24
    decode = mode.startswith("decode")
    if decode:
        length = {"decode at 0": 0, "decode at 9": 9, "decode at 23": 23,
                  "decode clamped at S_max": T}[mode]
        S, pos = 1, np.array([length])
        cache = _mla_cache(cfg, rng, B, T, length)
    else:
        S, pos = 16, np.arange(16)
        cache = (None if mode == "prefill" else
                 (np.zeros((B, T, cfg.mla.kv_lora_rank), np.float32),
                  np.zeros((B, T, cfg.mla.qk_rope_dim), np.float32),
                  np.int32(0)))
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    (out, tc), (jout, jc) = _mla_both(cfg, jcfg, tree, mla, x, pos, cache,
                                      decode)
    assert tuple(out.shape) == jout.shape == (B, S, cfg.d_model)
    _mla_close(out.numpy(), jout, "out")
    if cache is None:
        assert tc is None and jc is None
        return
    _mla_close(tc.k.numpy(), jc.k, "c_kv")
    _mla_close(tc.v.numpy(), jc.v, "k_rope")
    assert int(tc.length) == int(jc.length)
    if mode == "decode clamped at S_max":      # the last slot was written
        assert not np.array_equal(tc.k.numpy()[:, -1], cache[0][:, -1])


def test_mla_decode_equals_prefill():
    """On the port alone: prefilling 13 tokens into a cache, then decoding
    3 one at a time (the absorbed form against ``c_kv`` and ``k_rope``),
    gives the outputs of one prefill of all 16 (expanded K/V, plain scan),
    and the same cache."""
    cfg, _, _, mla = _mla_case()
    x = torch.tensor(np.random.default_rng(7).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        cache = tmodel.init_caches(cfg, 2, 16, dtype=torch.float32,
                                   device="cpu")[0]
        full, full_cache = mla_apply(mla, x, cfg,
                                     positions=torch.arange(16),
                                     cache=cache, decode=False)
        full_c = [t.clone() for t in full_cache[:2]]
        cache = tmodel.init_caches(cfg, 2, 16, dtype=torch.float32,
                                   device="cpu")[0]
        out, cache = mla_apply(mla, x[:, :13], cfg,
                               positions=torch.arange(13), cache=cache,
                               decode=False)
        steps = [out]
        for t in range(13, 16):
            o, cache = mla_apply(mla, x[:, t:t + 1], cfg,
                                 positions=torch.tensor([t]), cache=cache,
                                 decode=True)
            steps.append(o)
    assert int(cache.length) == 16
    _mla_close(torch.cat(steps, 1).numpy(), full.numpy(), "outputs")
    for got, want, what in zip(cache[:2], full_c, ("c_kv", "k_rope")):
        _mla_close(got.numpy(), want.numpy(), what)


def test_deepseek_plan_is_a_dense_prefix_then_moe():
    """deepseek-v2's first layer is the dense prefix (an ``MLP`` FFN of
    d_ff 12,288), every later one MoE; every mixer is MLA, its cache
    ``(B, S_max, kv_lora)`` and ``(B, S_max, rope)``. At full width (the
    plan and cache shapes only) and in the smoke model."""
    full = dataclasses.replace(get_config(DEEPSEEK), n_layers=2)
    assert tmodel.layer_plan(full) == [("attn", "mlp"), ("attn", "moe")]
    cfg = _cfgs(DEEPSEEK)[0]
    model = tmodel.Model(cfg, device="cpu")
    assert isinstance(model.layers[0].ffn, MLP)
    assert model.layers[0].ffn.w1.out_features == cfg.d_ff
    assert all(isinstance(b.ffn, MoE) for b in model.layers[1:])
    assert all(isinstance(b.mixer, MLA) for b in model.layers)
    caches = tmodel.init_caches(cfg, 2, 10, dtype=torch.float32,
                                device="cpu")
    assert all(tuple(c.k.shape) == (2, 10, cfg.mla.kv_lora_rank)
               and tuple(c.v.shape) == (2, 10, cfg.mla.qk_rope_dim)
               for c in caches)
