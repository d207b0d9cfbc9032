"""``cfg.remat`` in the port's trainer: ``"full"`` and ``"dots"`` change
what the backward pass keeps, never a value.

For the smoke variants of six families (smollm: dense; phi3.5-moe: MoE;
deepseek-v2: MLA and a dense prefix; mamba2: SSM; jamba: hybrid; hubert:
the encoder), float32 on the CPU from the same ``numpy_params`` weights
and data rows:

* under ``"full"`` and ``"dots"``, the loss, every step-0 gradient, and
  one train step's loss, ``grad_norm`` and updated parameters equal
  ``"none"``'s bit for bit (the recompute runs the same ops on the same
  inputs);
* each mode's step is held to the JAX package's ``make_train_step`` with
  ``Sharder()`` within ``tests/test_torch_train.py``'s tolerances (that
  file holds the step-0 gradients of the default ``"full"`` to JAX's,
  leaf by leaf);
* what the forward leaves for the backward orders ``"full"`` <
  ``"dots"`` < ``"none"``. An outer ``saved_tensors_hooks`` sees only the
  tensors saved outside the checkpointed periods (the checkpoint's own
  hook sits inside it and keeps a placeholder, and the selective
  checkpoint keeps the matmuls' outputs in a cache of its own), so the
  three modes are told apart by the device storages still live after the
  forward (``roofline_hlo.analyze`` on ``meta``), and the hooks only
  show that ``"none"`` saves inside the periods and the other two do not.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from test_torch_train import LOSS_TOL, NORM_TOL, _rel

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.data.pipeline import DataConfig, rows_batch
from repro.models import model as jmodel
from repro.models.layers import Sharder
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.train import step as jstep
from repro_torch.configs.base import get_config, smoke_variant
from repro_torch.interop import model_from_params, numpy_params
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.roofline_hlo import analyze
from repro_torch.train import step as tstep

ARCHS = ["smollm-135m", "phi3.5-moe-42b-a6.6b", "deepseek-v2-236b",
         "mamba2-370m", "jamba-v0.1-52b", "hubert-xlarge"]
MODES = ("none", "full", "dots")
B, S = 4, 32
OPT = dict(warmup_steps=2, decay_steps=10)


def _cfgs(arch):
    cfg, jcfg = (smoke_variant(get_config(arch)),
                 jax_smoke_variant(jax_get_config(arch)))
    if cfg.moe is not None:        # the paper's router
        cfg, jcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, router="flow")) for c in (cfg, jcfg))
    return cfg, jcfg


def _rows(cfg):
    return rows_batch(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                                 frontend_dim=cfg.frontend_dim), 0, 0, B)


def _port(cfg, params, rows, mode):
    """Step-0 loss and gradients, then one train step, under ``mode``."""
    cfg = dataclasses.replace(cfg, remat=mode)
    batch = {k: torch.tensor(x) for k, x in rows.items()}
    model = model_from_params(cfg, params, "cpu")
    ps = tstep.params_of(model)
    loss, _ = tstep.loss_fn(model, batch)
    grads = dict(zip(ps, torch.autograd.grad(loss, list(ps.values()),
                                             allow_unused=True)))
    tt = tstep.TrainConfig(optimizer=AdamWConfig(**OPT))
    state = tstep.init_train_state(cfg, tt, model)
    _, metrics = tstep.make_train_step(cfg, tt)(state, batch)
    return model, loss.detach(), grads, metrics, {
        n: p.detach().clone() for n, p in ps.items()}


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    arch = request.param
    cfg, jcfg = _cfgs(arch)
    params = numpy_params(cfg, seed=0)
    rows = _rows(cfg)
    return arch, cfg, jcfg, params, rows, {
        mode: _port(cfg, params, rows, mode) for mode in MODES}


def test_remat_equals_none_bit_for_bit(family):
    arch, *_, runs = family
    _, loss0, g0, m0, p0 = runs["none"]
    for mode in ("full", "dots"):
        _, loss, g, m, p = runs[mode]
        assert torch.equal(loss, loss0), (arch, mode)
        assert g.keys() == g0.keys()
        for n in g0:
            assert (g[n] is None) == (g0[n] is None), (arch, mode, n)
            if g0[n] is not None:
                assert torch.equal(g[n], g0[n]), (arch, mode, n)
        for key in ("loss", "grad_norm", "lr", "tokens"):
            assert torch.equal(m[key], m0[key]), (arch, mode, key)
        assert all(torch.equal(p[n], p0[n]) for n in p0), (arch, mode)


def test_each_mode_matches_jax(family):
    arch, cfg, jcfg, params, rows, runs = family
    jb = {k: jnp.asarray(x) for k, x in rows.items()}
    jp = jax.tree.map(jnp.asarray, params)
    axes = jmodel.init_model(jcfg, jax.random.PRNGKey(0))[1]
    jt = jstep.TrainConfig(optimizer=JAdamW(**OPT))
    _, jm = jax.jit(jstep.make_train_step(jcfg, axes, jt, Sharder()))(
        jstep.init_train_state(jcfg, jt, jp), jb)
    for mode in MODES:
        m = runs[mode][3]
        assert _rel(m["loss"], jm["loss"]) <= LOSS_TOL, (arch, mode)
        assert _rel(m["grad_norm"], jm["grad_norm"]) <= NORM_TOL, (arch,
                                                                   mode)
        assert m["lr"].numpy().tobytes() == \
            jax.numpy.asarray(jm["lr"]).tobytes()
        assert float(m["tokens"]) == float(jm["tokens"]) == B * S


def _kept(arch, mode):
    """Bytes the forward leaves live for the backward (``meta``; the
    inputs and parameters excluded), and the bytes an outer
    ``saved_tensors_hooks`` is asked to pack."""
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), remat=mode)
    model = Model(cfg, device="meta")
    rows = _rows(cfg)
    batch = {k: torch.empty(x.shape, dtype=torch.from_numpy(x).dtype,
                            device="meta") for k, x in rows.items()}
    packed = []

    def pack(t):
        packed.append(t.untyped_storage().nbytes())
        return t

    def forward(model, batch):
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            return tstep.loss_fn(model, batch)[0]
    acc = analyze(forward, model, batch)
    return acc["end_bytes"] - acc["entry_bytes"], sum(packed)


@pytest.mark.parametrize("arch", ARCHS)
def test_saved_bytes_order(arch):
    kept = {mode: _kept(arch, mode) for mode in MODES}
    assert kept["full"][0] < kept["dots"][0] < kept["none"][0], kept
    assert kept["full"][1] == kept["dots"][1] < kept["none"][1], kept
