"""The port's encoder stack and input frontend against the JAX package:
hubert-xlarge's smoke variant (4 layers of non-causal MHA without RoPE,
LayerNorm with biases, a tanh-GELU MLP, the ``frontend`` projection of
512-wide frame embeddings and the sinusoidal positions).

Both packages start from the same ``numpy_params`` weights and the same
frames and labels (the JAX package's ``rows_batch``), float32 on the CPU,
and differ only in summation order. Tolerances:

* ``sinusoidal_pos`` within ``POS_TOL`` absolute: the two ``pow``s give
  frequencies up to 2 ulp apart (in 9 of 640 at d_model 1280), and a
  position below 1100 times that moves an entry of ``sin`` / ``cos`` by
  under 5e-5;
* the logits within ``LOGIT_TOL`` x JAX's largest |logit|, as in
  ``test_torch_models.py``;
* the train step as ``test_torch_train.py`` holds it: the loss within
  ``LOSS_TOL`` relative at step 0 and 10 x that at step 1, the learning
  rate bit for bit, ``grad_norm`` within ``NORM_TOL`` relative, each
  leaf of the step-0 gradients within ``GRAD_TOL`` x that leaf's largest
  |value|; ``embed`` gets no gradient through a frontend, so both give
  exactly zero there.

``test_numpy_params_of_the_constant_archs_unchanged`` pins
``numpy_params`` of the four archs whose card constants are committed
(smollm, phi3.5-moe, deepseek-v2, mamba2) to the digests it had before
the ``frontend`` leaf was added: the new leaf is drawn after every other
one, so their weights do not move.
"""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.data.pipeline import DataConfig, rows_batch
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models.layers import Sharder
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.train import step as jstep
from repro_torch.configs.base import get_config, smoke_variant
from repro_torch.interop import (load_params, model_from_params,
                                 numpy_params, params_tree)
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import step as tstep

HUBERT = "hubert-xlarge"
POS_TOL = 5e-5
LOGIT_TOL = 1e-5
LOSS_TOL = 1e-6
NORM_TOL = 1e-5
GRAD_TOL = 1e-4
B, S = 4, 32
# sha256 of numpy_params(smoke_variant(arch), seed=0), taken before the
# frontend leaf existed (``_digest``)
PARAM_DIGESTS = {
    "smollm-135m":
        "e122592a87a405099af35965ff2ba66f408017f5126818dcbadd432778fb7e31",
    "phi3.5-moe-42b-a6.6b":
        "3cef5d7405f6eddcf0aa52a6c3947a411e33d858430ad7d6511953e1cf3ce1e5",
    "deepseek-v2-236b":
        "6d9e658d586f2e81109da2ca82a1cbb9f9f6d1b8fd8b4c66c104d6c6a0eff86b",
    "mamba2-370m":
        "8fddec165f512178b02295e1c3ece58e6b1490a54a8dfb4e57fc057438f5c055",
}


def _cfgs():
    return (smoke_variant(get_config(HUBERT)),
            jax_smoke_variant(jax_get_config(HUBERT)))


def _axes(jcfg):
    return jmodel.init_model(jcfg, jax.random.PRNGKey(0))[1]


def _batch(cfg, step):
    return rows_batch(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                                 frontend_dim=cfg.frontend_dim), step, 0, B)


def _both(b):
    return ({k: jnp.asarray(x) for k, x in b.items()},
            {k: torch.tensor(x) for k, x in b.items()})


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


@pytest.mark.parametrize("d_model,offset", [(1280, 0), (128, 37)])
def test_sinusoidal_pos_matches_jax(d_model, offset):
    pos = offset + np.arange(1024)
    got = tlayers.sinusoidal_pos(torch.tensor(pos), d_model)
    want = np.asarray(jlayers.sinusoidal_pos(jnp.asarray(pos), d_model))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=POS_TOL)


@pytest.mark.parametrize("mode", ["all", "last"])
def test_encoder_forward_matches_jax(mode):
    """``apply_model`` on seeded frames: the frontend replaces the token
    lookup and the sinusoidal positions are added, as in JAX."""
    cfg, jcfg = _cfgs()
    assert not cfg.causal and not cfg.rope_theta and cfg.frontend_dim
    params = numpy_params(cfg, seed=0)
    embeds = np.random.default_rng(2).standard_normal(
        (2, 48, cfg.frontend_dim), dtype=np.float32)
    want = jmodel.apply_model(params, _axes(jcfg), jcfg, Sharder(),
                              {"embeds": jnp.asarray(embeds)},
                              logits_mode=mode).logits
    model = model_from_params(cfg, params, "cpu")
    with torch.no_grad():
        got = tmodel.apply_model(model, {"embeds": torch.tensor(embeds)},
                                 logits_mode=mode).logits
    assert tuple(got.shape) == want.shape
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())


def test_encoder_is_not_causal():
    """A frame late in the sequence moves the logits of the first one (a
    causal stack would leave them alone)."""
    cfg, _ = _cfgs()
    model = model_from_params(cfg, numpy_params(cfg, seed=0), "cpu")
    x = torch.tensor(np.random.default_rng(3).standard_normal(
        (1, 16, cfg.frontend_dim), dtype=np.float32))
    y = x.clone()
    y[0, -1] += 1.0
    with torch.no_grad():
        a = tmodel.apply_model(model, {"embeds": x}).logits
        b = tmodel.apply_model(model, {"embeds": y}).logits
    assert (a[0, 0] - b[0, 0]).abs().max() > 1e-4


def test_encoder_grads_match_jax():
    """The step-0 gradients of ``loss_fn``, leaf by leaf, ``frontend``
    included, and ``embed``'s exactly zero on both sides."""
    cfg, jcfg = _cfgs()
    params = numpy_params(cfg, seed=0)
    jb, tb = _both(_batch(cfg, 0))
    axes = _axes(jcfg)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jstep.loss_fn(p, axes, jcfg, Sharder(), b),
        has_aux=True))(jax.tree.map(jnp.asarray, params), jb)
    model = model_from_params(cfg, params, "cpu")
    loss, aux = tstep.loss_fn(model, tb)
    ps = tstep.params_of(model)
    g = torch.autograd.grad(loss, list(ps.values()), allow_unused=True)
    assert g[list(ps).index("embed")] is None
    grads = {n: torch.zeros_like(p) if x is None else x
             for (n, p), x in zip(ps.items(), g)}
    assert _rel(loss.detach(), jloss) <= LOSS_TOL
    assert float(aux["tokens"]) == B * S
    got = params_tree(model, grads)
    assert jax.tree.structure(got) == jax.tree.structure(jgrads)
    assert not np.asarray(jgrads["embed"]).any()
    assert not got["embed"].any()
    assert np.abs(got["frontend"]).max() > 0
    for (path, want), x in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                               jax.tree.leaves(got)):
        want = np.asarray(want)
        assert x.shape == want.shape, path
        np.testing.assert_allclose(
            x, want, rtol=0, atol=GRAD_TOL * np.abs(want).max(),
            err_msg=jax.tree_util.keystr(path))


def test_two_encoder_train_steps_match_jax():
    """Two steps of ``make_train_step`` from the same start and rows:
    loss, lr and ``grad_norm`` each step; ``embed`` unchanged by AdamW's
    step on a zero gradient but for the weight decay, as in JAX."""
    cfg, jcfg = _cfgs()
    params = numpy_params(cfg, seed=0)
    opt = dict(warmup_steps=2, decay_steps=10)
    jt = jstep.TrainConfig(optimizer=JAdamW(**opt))
    tt = tstep.TrainConfig(optimizer=AdamWConfig(**opt))
    jstate = jstep.init_train_state(jcfg, jt, jax.tree.map(jnp.asarray,
                                                           params))
    jfn = jax.jit(jstep.make_train_step(jcfg, _axes(jcfg), jt, Sharder()))
    tstate = tstep.init_train_state(cfg, tt,
                                    model_from_params(cfg, params, "cpu"))
    tfn = tstep.make_train_step(cfg, tt)
    for step in range(2):
        jb, tb = _both(_batch(cfg, step))
        jstate, jm = jfn(jstate, jb)
        tstate, tm = tfn(tstate, tb)
        assert _rel(tm["loss"], jm["loss"]) <= LOSS_TOL * 10 ** step, step
        assert tm["lr"].numpy().tobytes() == np.asarray(jm["lr"]).tobytes()
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= NORM_TOL, step
    np.testing.assert_allclose(tstate.model.embed.detach().numpy(),
                               np.asarray(jstate.params["embed"]), rtol=0,
                               atol=1e-7)


def test_params_round_trip_with_the_frontend():
    """``numpy_params`` -> ``load_params`` -> ``params_tree`` gives every
    leaf back bit for bit, ``frontend`` (drawn with ``frontend_dim **
    -0.5``) and the LayerNorm biases included."""
    cfg, jcfg = _cfgs()
    params = numpy_params(cfg, seed=0)
    assert params["frontend"].shape == (cfg.frontend_dim, cfg.d_model)
    assert abs(params["frontend"].std() * cfg.frontend_dim ** 0.5 - 1) < 0.05
    assert "b" in params["final_norm"]
    assert "b" in params["body"]["sub0"]["norm1"]
    theirs = jmodel.init_model(jcfg, jax.random.PRNGKey(0))[0]
    assert jax.tree.structure(params) == jax.tree.structure(theirs)
    model = load_params(tmodel.Model(cfg, device="cpu"), params)
    back = params_tree(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(params),
                            jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


def _digest(tree) -> str:
    """sha256 over every leaf (path, dtype, shape, bytes), dicts in sorted
    key order."""
    h = hashlib.sha256()

    def walk(path, x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(f"{path}/{k}", x[k])
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(f"{path}/{i}", v)
        else:
            a = np.ascontiguousarray(x)
            h.update(f"{path}:{a.dtype}:{a.shape}".encode())
            h.update(a.tobytes())
    walk("", tree)
    return h.hexdigest()


@pytest.mark.parametrize("arch", sorted(PARAM_DIGESTS))
def test_numpy_params_of_the_constant_archs_unchanged(arch):
    params = numpy_params(smoke_variant(get_config(arch)), seed=0)
    assert "frontend" not in params
    assert _digest(params) == PARAM_DIGESTS[arch]


def test_encoder_constants_fit_the_smoke():
    """The committed encoder constants were made for ``phase_encoder``'s
    setup: the logits at ``sample_positions`` of every request, three
    steps of loss, lr and grad_norm, the sampled step-0 gradients of
    ENCODER_LEAVES in their JAX shapes, and the SHA-256 of rows this
    machine's pipeline gives too (``rng.normal`` / ``rng.integers``)."""
    import json

    import chip_smoke
    from repro_torch.data.pipeline import rows_batch as port_rows
    want = json.loads(chip_smoke.ENCODER_CONSTANTS.read_text())
    setup = chip_smoke.encoder_setup()
    assert {k: want[k] for k in setup} == setup
    assert len(want["steps"]) == chip_smoke.ENC_STEPS
    cfg = get_config(HUBERT)
    logits = np.load(chip_smoke.ENCODER_LOGITS)["logits"]
    assert logits.shape == (chip_smoke.ENC_B, len(setup["positions"]),
                            cfg.vocab)
    assert np.isfinite(logits).all()
    D, F = cfg.d_model, cfg.d_ff
    shapes = {"frontend.weight": [cfg.frontend_dim, D],
              "layers.0.mixer.wq.weight": [D, cfg.n_heads * cfg.dh],
              f"layers.{cfg.n_layers - 1}.ffn.w2.weight": [F, D],
              "final_norm.b": [D], "lm_head.weight": [D, cfg.vocab]}
    assert {k: v["shape"] for k, v in want["grads"].items()} == shapes
    for rec in want["grads"].values():
        assert len(rec["index"]) == len(rec["value"]) > 500
        assert max(abs(x) for x in rec["value"]) == rec["absmax"] > 0
    fwd = chip_smoke.encoder_data(chip_smoke.ENC_B)
    assert want["rows"]["forward"] == chip_smoke.rows_digest(
        port_rows(fwd, 0, 0, chip_smoke.ENC_B))
    train = chip_smoke.encoder_data(chip_smoke.ENC_TRAIN_B)
    assert want["rows"]["train"] == [
        chip_smoke.rows_digest(port_rows(train, s, 0, chip_smoke.ENC_TRAIN_B))
        for s in range(chip_smoke.ENC_STEPS)]
