"""The port's train step (``repro_torch.train.step``) against the JAX
package's ``make_train_step`` with ``Sharder()`` (no mesh).

Both start from the same ``numpy_params`` weights and the same data rows
(the JAX package's ``rows_batch``), float32 on the CPU. They differ only
in summation order (the port's attention backward is the reference's
``_flash_core_bwd`` in its operation order, its MoE routers see the same
detached scores), so:

* the loss within ``LOSS_TOL`` x |JAX's loss| at step 0 and 10 x that at
  step 1, which follows an update each side took from its own gradients
  (float32 sums over the batch's tokens),
* the learning rate bit for bit (the same float32 operations),
* ``grad_norm`` within ``NORM_TOL`` x JAX's (``BF16_NORM_TOL`` where the
  gradients are rounded to bfloat16 before it is taken: a value that
  lies within the float32 differences of a bfloat16 rounding boundary
  rounds the other way),
* every leaf of the step-0 gradients within ``GRAD_TOL`` x the largest
  |value| of that leaf of JAX's (``repro_torch.interop.params_tree``
  lays the port's out as the JAX tree).

Parameters after the steps are not compared leaf by leaf: AdamW divides
a gradient by its own root mean square, so where a gradient is zero up
to rounding a difference of rounding moves the parameter by a whole
learning rate; the second step's loss carries the update instead.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.data.pipeline import DataConfig, rows_batch
from repro.models import model as jmodel
from repro.models.layers import Sharder
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.train import step as jstep
from repro_torch.configs.base import get_config, smoke_variant
from repro_torch.interop import model_from_params, numpy_params, params_tree
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import step as tstep

LOSS_TOL = 1e-6
NORM_TOL = 1e-5
BF16_NORM_TOL = 1e-4
GRAD_TOL = 1e-4
ARCHS = ["smollm-135m", "phi3.5-moe-42b-a6.6b", "deepseek-v2-236b",
         "mamba2-370m", "jamba-v0.1-52b"]
B, S = 4, 32


def _cfgs(arch):
    cfg, jcfg = (smoke_variant(get_config(arch)),
                 jax_smoke_variant(jax_get_config(arch)))
    if cfg.moe is not None:        # the paper's router
        cfg, jcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, router="flow")) for c in (cfg, jcfg))
    return cfg, jcfg


def _batch(cfg, step, mask=False):
    b = rows_batch(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B),
                   step, 0, B)
    if mask:        # the last quarter of every row does not count
        m = np.ones((B, S), np.float32)
        m[:, 3 * S // 4:] = 0
        b["mask"] = m
    return b


def _both(b):
    return ({k: jnp.asarray(x) for k, x in b.items()},
            {k: torch.tensor(x) for k, x in b.items()})


def _setup(arch, **tkw):
    cfg, jcfg = _cfgs(arch)
    params = numpy_params(cfg, seed=0)
    axes = jmodel.init_model(jcfg, jax.random.PRNGKey(0))[1]
    opt = dict(warmup_steps=2, decay_steps=10)
    jt = jstep.TrainConfig(optimizer=JAdamW(**opt), **tkw)
    tt = tstep.TrainConfig(optimizer=AdamWConfig(**opt), **tkw)
    return cfg, jcfg, params, axes, jt, tt


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


def _grads_close(model, grads, jgrads, what):
    got = params_tree(model, grads)
    assert (jax.tree.structure(got) == jax.tree.structure(jgrads)), what
    for (path, want), g in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                               jax.tree.leaves(got)):
        want = np.asarray(want)
        assert g.shape == want.shape, (what, path)
        np.testing.assert_allclose(
            g, want, rtol=0, atol=GRAD_TOL * np.abs(want).max(),
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _run_steps(arch, n_steps=2, mask=False, **tkw):
    """n_steps of each side's train step from the same start; returns the
    per-step metrics of both."""
    cfg, jcfg, params, axes, jt, tt = _setup(arch, **tkw)
    jstate = jstep.init_train_state(jcfg, jt, jax.tree.map(jnp.asarray,
                                                           params))
    jfn = jax.jit(jstep.make_train_step(jcfg, axes, jt, Sharder()))
    tstate = tstep.init_train_state(
        cfg, tt, model_from_params(cfg, params, "cpu"))
    tfn = tstep.make_train_step(cfg, tt)
    out = []
    for step in range(n_steps):
        jb, tb = _both(_batch(cfg, step, mask))
        jstate, jm = jfn(jstate, jb)
        tstate, tm = tfn(tstate, tb)
        out.append((jm, tm))
    return out


def _check_metrics(steps, norm_tol=NORM_TOL):
    for i, (jm, tm) in enumerate(steps):
        assert _rel(tm["loss"], jm["loss"]) <= LOSS_TOL * 10 ** i, i
        lr_j, lr_t = np.asarray(jm["lr"]), tm["lr"].numpy()
        assert lr_t.dtype == lr_j.dtype == np.float32
        assert lr_t.tobytes() == lr_j.tobytes(), i
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= norm_tol, i
        assert float(tm["tokens"]) == float(jm["tokens"]), i


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    """``loss_fn`` and its step-0 gradients, leaf by leaf."""
    cfg, jcfg, params, axes, *_ = _setup(arch)
    jb, tb = _both(_batch(cfg, 0))
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jstep.loss_fn(p, axes, jcfg, Sharder(), b),
        has_aux=True))(jax.tree.map(jnp.asarray, params), jb)
    model = model_from_params(cfg, params, "cpu")
    loss, aux = tstep.loss_fn(model, tb)
    ps = tstep.params_of(model)
    grads = dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))
    assert _rel(loss.detach(), jloss) <= LOSS_TOL
    assert float(aux["tokens"]) == float(jaux["tokens"]) == B * S
    _grads_close(model, grads, jgrads, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_train_steps_match_jax(arch):
    _check_metrics(_run_steps(arch))


def test_microbatches_match_jax():
    """``num_microbatches=2``: gradients summed over two row halves, then
    halved; the loss the mean of the halves' and ``tokens`` 0."""
    steps = _run_steps("smollm-135m", num_microbatches=2)
    _check_metrics(steps)
    assert all(float(tm["tokens"]) == 0 for _, tm in steps)


def test_bf16_grads_match_jax():
    steps = _run_steps("smollm-135m", grad_dtype="bf16")
    _check_metrics(steps, norm_tol=BF16_NORM_TOL)


def test_bf16_microbatches_match_jax():
    """Microbatch gradients summed in bfloat16."""
    _check_metrics(_run_steps("phi3.5-moe-42b-a6.6b", num_microbatches=2,
                              grad_dtype="bf16"), norm_tol=BF16_NORM_TOL)


def test_mask_matches_jax():
    """A mask weighs the tokens: loss over the unmasked ones, ``tokens``
    their count, gradients and two steps as JAX's."""
    cfg, jcfg, params, axes, *_ = _setup("smollm-135m")
    jb, tb = _both(_batch(cfg, 0, mask=True))
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jstep.loss_fn(p, axes, jcfg, Sharder(), b),
        has_aux=True))(jax.tree.map(jnp.asarray, params), jb)
    model = model_from_params(cfg, params, "cpu")
    loss, aux = tstep.loss_fn(model, tb)
    ps = tstep.params_of(model)
    grads = dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))
    assert _rel(loss.detach(), jloss) <= LOSS_TOL
    assert float(aux["tokens"]) == float(jaux["tokens"]) == B * S * 3 // 4
    _grads_close(model, grads, jgrads, "mask")
    unmasked, _ = tstep.loss_fn(model, {k: v for k, v in tb.items()
                                        if k != "mask"})
    assert abs(float(unmasked) - float(loss)) > 1e-3
    _check_metrics(_run_steps("smollm-135m", mask=True))


def test_state_tree_round_trip(tmp_path):
    """The train state through ``checkpoint.store``: every leaf back bit
    for bit, the parameters copied into the model in place."""
    from repro_torch.checkpoint import store
    cfg, _, params, _, _, tt = _setup("smollm-135m")
    model = model_from_params(cfg, params, "cpu")
    state = tstep.init_train_state(cfg, tt, model)
    state, _ = tstep.make_train_step(cfg, tt)(state, _both(_batch(cfg, 0))[1])
    tree = tstep.state_tree(state)
    store.save(str(tmp_path), 1, tree)
    fresh = tstep.init_train_state(
        cfg, tt, model_from_params(cfg, params, "cpu"))
    back = tstep.load_state_tree(fresh, store.restore(
        str(tmp_path), 1, tstep.state_tree(fresh), device="cpu"))
    a, b = tstep.state_tree(state), tstep.state_tree(back)
    from repro_torch.core.masking import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb) and int(back.opt.step) == 1
    assert all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(la, lb))
    assert back.model is fresh.model


def test_train_constants_fit_the_smoke():
    """The committed training constants were made for ``phase_train``'s
    setup: three steps of loss, lr and grad_norm, the sampled step-0
    gradients of TRAIN_LEAVES in their JAX shapes, and the rows the
    card's ``make_batch`` gives (tokens shifted by one into labels)."""
    import json

    import chip_smoke
    want = json.loads(chip_smoke.TRAIN_CONSTANTS.read_text())
    assert {k: want[k] for k in chip_smoke.train_setup()} == \
        chip_smoke.train_setup()
    assert len(want["steps"]) == chip_smoke.TRAIN_STEPS
    cfg = get_config(chip_smoke.TRAIN_ARCH)
    shapes = {"embed": [cfg.vocab, cfg.d_model],
              "layers.0.mixer.wq.weight": [cfg.d_model,
                                           cfg.n_heads * cfg.dh],
              f"layers.{cfg.n_layers - 1}.ffn.w2.weight": [cfg.d_ff,
                                                           cfg.d_model],
              "final_norm.g": [cfg.d_model]}
    assert {k: v["shape"] for k, v in want["grads"].items()} == shapes
    for rec in want["grads"].values():
        assert len(rec["index"]) == len(rec["value"]) > 500
        assert max(abs(x) for x in rec["value"]) == rec["absmax"] > 0
    rows = np.load(chip_smoke.TRAIN_ROWS)
    shape = (chip_smoke.TRAIN_STEPS, chip_smoke.TRAIN_B, chip_smoke.TRAIN_S)
    assert rows["tokens"].shape == rows["labels"].shape == shape
    assert np.array_equal(rows["tokens"][..., 1:], rows["labels"][..., :-1])
    assert 0 <= rows["tokens"].min() and rows["tokens"].max() < cfg.vocab


@pytest.mark.parametrize("fault", [None, "lse in base 2", "scale dropped"])
def test_train_grad_check_catches_a_wrong_attention_backward(fault,
                                                            monkeypatch):
    """``chip_smoke.check_train_grads`` at TRAIN_GRAD_TOL passes the
    port's own step-0 gradients and fails a backward that reads the
    log-sum-exp in base 2 or drops the softmax scale (smollm's smoke
    width at 30 layers, so that TRAIN_LEAVES exist)."""
    import chip_smoke
    from repro_torch.models import attention as tattn
    cfg = dataclasses.replace(smoke_variant(get_config("smollm-135m")),
                              n_layers=30)
    params = numpy_params(cfg, seed=0)
    batch = {k: torch.tensor(x) for k, x in _batch(cfg, 0).items()}

    def leaf_grads():
        model = model_from_params(cfg, params, "cpu")
        ps = tstep.params_of(model)
        loss, _ = tstep.loss_fn(model, batch)
        g = torch.autograd.grad(loss, [ps[n] for n in chip_smoke.TRAIN_LEAVES])
        return dict(zip(chip_smoke.TRAIN_LEAVES, g))
    want = {}
    for name, g in leaf_grads().items():
        flat = chip_smoke.jax_layout(name, g).reshape(-1)
        want[name] = dict(shape=list(chip_smoke.jax_layout(name, g).shape),
                          index=list(range(flat.size)),
                          value=flat.astype(np.float64).tolist(),
                          absmax=float(np.abs(flat).max()))
    bwd = tattn._flash_core_bwd

    def broken(causal, scale, chunk, res, dout):
        q, k, v, out32, lse = res
        if fault == "lse in base 2":
            lse = lse * 1.4426950408889634
        return bwd(causal, 1.0 if fault == "scale dropped" else scale,
                   chunk, (q, k, v, out32, lse), dout)
    monkeypatch.setattr(tattn, "_flash_core_bwd", broken)
    got = leaf_grads()
    if fault is None:
        assert max(chip_smoke.check_train_grads(got, want).values()) == 0
    else:
        with pytest.raises(AssertionError, match="train step-0 grad"):
            chip_smoke.check_train_grads(got, want)


def test_microbatches_must_split_the_batch():
    cfg, _, params, _, _, tt = _setup("smollm-135m", num_microbatches=3)
    state = tstep.init_train_state(cfg, tt, model_from_params(cfg, params,
                                                               "cpu"))
    with pytest.raises(ValueError, match="microbatches"):
        tstep.make_train_step(cfg, tt)(state, _both(_batch(cfg, 0))[1])
