"""The port's int8 KV cache (``KVCacheQ``, ``cfg.kv_quant``) against the
JAX package, on the CPU.

* ``_quant_kv`` bit for bit: the same float32 operations (a max, a true
  division by 127, a true division by the clamped scale, rounding half to
  even), so codes and scales are equal to the last bit, ties at .5 and
  all-zero rows included.
* A prefill into the cache of smollm-135m's smoke variant with
  ``kv_quant=True``: the cache holds ``_quant_kv`` of the keys and values
  of the same prefill on a float cache, bit for bit (codes ``(B, S_max,
  KV, dh)`` int8, scales ``(B, S_max, KV, 1)`` float32, zeros past the
  prompt); against JAX's it holds the same codes (its keys differ by float32
  summation order only, a few ulp; a code could flip only where a value
  lies within that of a .5 boundary, and none does on these inputs) and
  scales within ``LOGIT_TOL`` x their largest |value|.
* Four decode steps: each step's logits within ``LOGIT_TOL`` x JAX's
  largest |logit| (float32, other summation orders), every cache field
  as above.
* The reference's own check (``tests/test_models.py::
  test_kv_quant_decode_consistency``) on the port: a decode step on the
  int8 cache against a full forward, within its 5e-2 of the largest
  |logit| (the quantisation error, not summation order).
* ``make_prefill_step`` / ``make_serve_step`` (``greedy_generate``) on a
  list of ``KVCacheQ`` caches: the JAX package's tokens and, by
  ``chip_smoke.check_serve``, its logits within ``LOGIT_TOL``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_smoke_constants as consts

import chip_smoke
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models.layers import Sharder
from repro_torch.configs.base import get_config, smoke_variant
from repro_torch.interop import model_from_params, numpy_params
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.attention import KVCacheQ
from repro_torch.serve.engine import (greedy_generate, make_prefill_step,
                                      make_serve_step)

LOGIT_TOL = 1e-5
QUANT_TOL = 5e-2
FIELDS = ("k_q", "k_s", "v_q", "v_s")
B, S = 2, 16


def _cfgs(quant=True):
    cfg = smoke_variant(get_config("smollm-135m"))
    jcfg = jax_smoke_variant(jax_get_config("smollm-135m"))
    return (dataclasses.replace(cfg, kv_quant=quant),
            dataclasses.replace(jcfg, kv_quant=quant))


def _axes(jcfg):
    return jmodel.init_model(jcfg, jax.random.PRNGKey(0))[1]


def _quant_inputs():
    """Seeded normal rows at three magnitudes, a row of exact ties (max
    127 so the scale is 1, every other value k + .5), an all-zero row and
    a row of one nonzero value."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 24, 4, 64)).astype(np.float32)
    x *= np.array([1e-3, 1.0, 300.0], np.float32)[:, None, None, None]
    x[0, 0, 0] = np.arange(64) - 31.5
    x[0, 0, 0, 0] = 127.0
    x[0, 0, 1] = -(np.arange(64) % 7 + 0.5) * 2
    x[0, 0, 1, 5] = -127.0 * 2
    x[1, 3, 2] = 0.0
    x[2, 5, 3] = 0.0
    x[2, 5, 3, 17] = -4.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_kv_bits_match_jax(dtype):
    x = _quant_inputs()
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    jq, js = jattn._quant_kv(jx)
    tq, ts = tattn._quant_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == x.shape[:-1] + (1,)
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    # the scale is the true quotient max|x| / 127, not a product with
    # 1/127's float32 (the two differ in the last bit for some rows)
    m = np.abs(tx.float().numpy()).max(-1, keepdims=True)
    assert ts.numpy().tobytes() == (m / np.float32(127)).tobytes()
    assert not np.array_equal(m / np.float32(127),
                              m * (np.float32(1) / np.float32(127)))
    if dtype == "float32":      # half to even at the ties, zeros stay 0
        assert tq[0, 0, 0, :6].tolist() == [127, -30, -30, -28, -28, -26]
        assert not tq[1, 3, 2].any() and not ts[1, 3, 2].any()
        assert tq[2, 5, 3, 17] == -127 and tq[2, 5, 3].abs().sum() == 127


def _jax_prefill(jcfg, params, toks, S_max):
    caches, _ = jmodel.init_caches(jcfg, B, S_max, dtype=jnp.float32)
    return jmodel.apply_model(params, _axes(jcfg), jcfg, Sharder(),
                              {"tokens": jnp.asarray(toks)}, caches=caches)


def _layer(cache_tree, i):
    body = cache_tree["body"][0]
    return type(body)(*(np.asarray(x)[i] for x in body))


def test_prefill_cache_matches_jax():
    cfg, jcfg = _cfgs()
    params = numpy_params(cfg, seed=0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S),
                                             dtype=np.int32)
    S_max = S + 4
    jq = _jax_prefill(jcfg, params, toks, S_max)
    model = model_from_params(cfg, params, "cpu")
    caches = tmodel.init_caches(cfg, B, S_max, dtype=torch.float32,
                                device="cpu")
    fcfg = _cfgs(False)[0]
    with torch.no_grad():
        pre = tmodel.apply_model(model, {"tokens": torch.tensor(toks)},
                                 caches=caches)
        flt = tmodel.apply_model(
            model_from_params(fcfg, params, "cpu"),
            {"tokens": torch.tensor(toks)},
            caches=tmodel.init_caches(fcfg, B, S_max, dtype=torch.float32,
                                      device="cpu")).caches
    np.testing.assert_allclose(pre.logits.numpy(), np.asarray(jq.logits),
                               rtol=0, atol=LOGIT_TOL * np.abs(
                                   np.asarray(jq.logits)).max())
    for i, got in enumerate(pre.caches):
        assert isinstance(got, KVCacheQ) and got.k_q is caches[i].k_q
        want = _layer(jq.caches, i)
        assert int(got.length) == int(want.length) == S
        # the port's prefill writes _quant_kv of its own keys and values:
        # those of the float cache's prefill, quantised, bit for bit
        for name in ("k", "v"):
            q, s = tattn._quant_kv(getattr(flt[i], name))
            assert torch.equal(getattr(got, name + "_q"), q), (i, name)
            assert torch.equal(getattr(got, name + "_s"), s), (i, name)
        for f in FIELDS:
            a, b = getattr(got, f).numpy(), getattr(want, f)
            assert a.dtype == b.dtype and a.shape == b.shape, (i, f)
            if f.endswith("_q"):
                assert np.array_equal(a, b), (i, f)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=LOGIT_TOL
                                           * np.abs(b).max(), err_msg=f)
        assert not got.k_q[:, S:].any() and not got.v_s[:, S:].any()


def test_decode_steps_match_jax():
    """A prefill of ``S`` tokens, then 4 decode steps fed JAX's greedy
    tokens: logits and caches each step."""
    cfg, jcfg = _cfgs()
    params = numpy_params(cfg, seed=0)
    axes, shd = _axes(jcfg), Sharder()
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S),
                                             dtype=np.int32)
    S_max = S + 4
    jout = _jax_prefill(jcfg, params, toks, S_max)
    model = model_from_params(cfg, params, "cpu")
    with torch.no_grad():
        out = tmodel.apply_model(
            model, {"tokens": torch.tensor(toks)},
            caches=tmodel.init_caches(cfg, B, S_max, dtype=torch.float32,
                                      device="cpu"))
        for t in range(4):
            nxt = np.asarray(jnp.argmax(jout.logits[:, -1], -1),
                             np.int32)[:, None]
            jout = jmodel.apply_model(params, axes, jcfg, shd,
                                      {"tokens": jnp.asarray(nxt)},
                                      caches=jout.caches, decode=True,
                                      pos_offset=S + t)
            out = tmodel.apply_model(model, {"tokens": torch.tensor(nxt)},
                                     caches=out.caches, decode=True,
                                     pos_offset=torch.tensor(S + t))
            want = np.asarray(jout.logits)
            np.testing.assert_allclose(
                out.logits.numpy(), want, rtol=0,
                atol=LOGIT_TOL * np.abs(want).max(), err_msg=f"step {t}")
            for i, got in enumerate(out.caches):
                ref = _layer(jout.caches, i)
                assert int(got.length) == int(ref.length) == S + t + 1
                assert np.array_equal(got.k_q.numpy(), ref.k_q), (t, i)
                assert np.array_equal(got.v_q.numpy(), ref.v_q), (t, i)
                np.testing.assert_allclose(got.v_s.numpy(), ref.v_s, rtol=0,
                                           atol=LOGIT_TOL * ref.v_s.max())


def test_kv_quant_decode_consistency():
    """The reference's test on the port: decode on the int8 cache matches
    a full forward within the quantisation tolerance."""
    cfg, _ = _cfgs()
    model = tmodel.init_model(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S)), dtype=torch.int32)
    with torch.no_grad():
        full = tmodel.apply_model(model, {"tokens": toks})
        caches = tmodel.init_caches(cfg, B, S + 4, dtype=torch.float32,
                                    device="cpu")
        pre = tmodel.apply_model(model, {"tokens": toks[:, :S - 1]},
                                 caches=caches)
        dec = tmodel.apply_model(model, {"tokens": toks[:, S - 1:]},
                                 caches=pre.caches, decode=True,
                                 pos_offset=S - 1)
    a, b = full.logits[:, -1], dec.logits[:, 0]
    err = float((a - b).abs().max() / (a.abs().max() + 1e-9))
    assert 0 < err < QUANT_TOL, err


def test_serve_steps_on_a_quantised_cache():
    """The serve steps on ``KVCacheQ`` caches: ``greedy_generate`` gives
    the JAX package's tokens; ``chip_smoke.port_serve`` (the smoke's
    loop over ``make_prefill_step`` / ``make_serve_step``) its logits."""
    cfg, jcfg = _cfgs()
    Bs, Ss, new = 3, 16, 6
    params = numpy_params(cfg, seed=1)
    prompts = chip_smoke.serve_prompts(cfg.vocab, Bs, Ss)
    jparams = jax.tree.map(jnp.asarray, params)
    want_tokens, want_logits = consts.jax_generate(jcfg, jparams,
                                                   _axes(jcfg), prompts, new)
    model = model_from_params(cfg, params, device="cpu")
    got = greedy_generate(model, torch.tensor(prompts), new)
    assert np.array_equal(got.numpy(), want_tokens)
    steps, *_, state = chip_smoke.port_serve(model, torch.tensor(prompts),
                                             new, Ss + new)
    assert all(isinstance(c, KVCacheQ) for c in state.caches)
    assert all(int(c.length) == Ss + new - 1 for c in state.caches)
    report = chip_smoke.check_serve(
        steps, [chip_smoke.top5_records(lg) for lg in want_logits],
        tol=LOGIT_TOL)
    assert report["steps_compared"] == [new] * Bs
    caches = tmodel.init_caches(cfg, Bs, Ss + new, dtype=torch.float32,
                                device="cpu")
    nxt, st = make_prefill_step(model)(torch.tensor(prompts), caches)
    nxt2, st = make_serve_step(model)(st)
    assert np.array_equal(torch.stack([nxt, nxt2], 1).numpy(),
                          want_tokens[:, :2])
    assert st.caches[0].k_q is caches[0].k_q


def test_kvq_constants_fit_the_smoke():
    """The committed kv-quant constants were made for ``phase_kvq``'s
    setup: smollm-135m with ``kv_quant``, SERVE_B x SERVE_S prompts and
    SERVE_NEW top-5 records per step, each request's largest |logit|."""
    import json
    want = json.loads(chip_smoke.KVQ_CONSTANTS.read_text())
    setup = chip_smoke.kvq_setup()
    assert {k: want[k] for k in setup} == setup
    assert len(want["steps"]) == chip_smoke.SERVE_NEW
    assert np.asarray(want["tokens"]).shape == (chip_smoke.SERVE_B,
                                                chip_smoke.SERVE_NEW)
    for rec in want["steps"]:
        assert np.asarray(rec["ids"]).shape == (chip_smoke.SERVE_B, 5)
        assert all(a > 0 for a in rec["absmax"])
