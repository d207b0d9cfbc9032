"""The port's roofline accounting (``repro_torch.roofline``,
``repro_torch.roofline_hlo``) against ``tests/test_roofline.py``'s
contract and against the reference's count of the same train step.

The loops count exactly: every iteration of a Python loop dispatches its
ops. The smollm train step's matmul FLOPs (smoke variant, 4 x 32 tokens,
float32 on the CPU) are held to ``repro.roofline_hlo.analyze`` of the
jitted ``make_train_step`` with ``Sharder()``: under ``remat="none"``
exactly. Under ``"full"`` and ``"dots"`` both count the recompute, and
the port's count is the reference's plus exactly one batched product a
layer: the port's recompute runs the whole attention forward (the scores
and the probabilities times v), the reference's HLO recomputes only the
scores' product (one more ``f32[4,4,32,32]`` dot a layer, not two).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.data.pipeline import DataConfig, rows_batch
from repro.launch.specs import SHAPES as JAX_SHAPES
from repro.models import model as jmodel
from repro.models.layers import Sharder
from repro.roofline import model_flops_for as jax_model_flops_for
from repro.roofline_hlo import analyze as jax_analyze
from repro.train import step as jstep
from repro_torch.configs.base import get_config, smoke_variant
from repro_torch.interop import model_from_params, numpy_params
from repro_torch.launch.dryrun import LM_ARCHS
from repro_torch.launch.specs import SHAPES
from repro_torch.roofline import (HBM_BW, LINK_BW, PEAK_FLOPS, Roofline,
                                  model_flops_for)
from repro_torch.roofline_hlo import analyze
from repro_torch.train import step as tstep


def test_loop_trip_counts_accounted():
    """A 10-trip loop of 512^3 matmuls counts exactly 10 matmuls."""
    def f(x, w):
        for _ in range(10):
            x = torch.tanh(x @ w)
        return x

    x, w = torch.randn(512, 512), torch.randn(512, 512)
    acc = analyze(f, x, w)
    assert acc["flops"] == 10 * 2 * 512 ** 3
    assert acc["by_op"]["aten.mm"]["count"] == 10


def test_nested_loop_multipliers():
    def f(x, w):
        for _ in range(3):
            for _ in range(4):
                x = x @ w
        return x

    acc = analyze(f, torch.empty(128, 128, device="meta"),
                  torch.empty(128, 128, device="meta"))
    assert acc["flops"] == 12 * 2 * 128 ** 3
    # each product reads two 64 KiB operands and writes one; the inputs
    # are live from entry and at most two products' outputs at a time
    assert acc["bytes"] == 12 * 3 * 128 * 128 * 4
    assert acc["entry_bytes"] == 2 * 128 * 128 * 4
    assert acc["peak_bytes"] == 4 * 128 * 128 * 4


def test_roofline_terms_and_bottleneck():
    """The terms at one H100's peaks: bf16 989 TFLOP/s, float32 67
    TFLOP/s off the tensor cores, 3.35 TB/s HBM, 450 GB/s NVLink."""
    rl = Roofline(arch="x", shape="train_4k", mesh="1", chips=1,
                  flops=989e12, bytes_accessed=3.35e12 * 2,
                  coll_bytes=450e9 * 0.5, coll_breakdown={},
                  model_flops=989e12 * 0.25, bytes_per_chip=1e9)
    assert rl.dtype == "bf16"
    assert abs(rl.t_compute - 1.0) < 1e-9
    assert abs(rl.t_memory - 2.0) < 1e-9
    assert abs(rl.t_collective - 0.5) < 1e-9
    assert rl.bottleneck == "memory"
    assert abs(rl.roofline_frac - 0.125) < 1e-9
    f32 = dataclasses.replace(rl, dtype="f32")
    assert abs(f32.t_compute - 989 / 67) < 1e-9
    assert f32.bottleneck == "compute"
    assert PEAK_FLOPS == {"bf16": 989e12, "f32": 67e12}
    assert (HBM_BW, LINK_BW) == (3.35e12, 450e9)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_model_flops_formula_equals_reference(arch):
    assert SHAPES == JAX_SHAPES
    for shape, info in SHAPES.items():
        assert (model_flops_for(get_config(arch), info)
                == jax_model_flops_for(jax_get_config(arch), info)), shape


def test_one_card_step_has_no_collectives():
    acc = analyze(lambda a, b: (a @ b).sum(), torch.ones(8, 8),
                  torch.ones(8, 8))
    assert acc["collectives"] == {} and acc["collective_bytes"] == 0.0


B, S = 4, 32


@functools.lru_cache(maxsize=None)
def _train_counts(mode):
    arch = "smollm-135m"
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), remat=mode)
    jcfg = dataclasses.replace(jax_smoke_variant(jax_get_config(arch)),
                               remat=mode)
    params = numpy_params(cfg, seed=0)
    rows = rows_batch(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B),
                      0, 0, B)
    axes = jmodel.init_model(jcfg, jax.random.PRNGKey(0))[1]
    jt = jstep.TrainConfig()
    jstate = jstep.init_train_state(jcfg, jt, jax.tree.map(jnp.asarray,
                                                           params))
    hlo = jax.jit(jstep.make_train_step(jcfg, axes, jt, Sharder())).lower(
        jstate, {k: jnp.asarray(x) for k, x in rows.items()}).compile()
    want = jax_analyze(hlo.as_text())["flops"]
    tt = tstep.TrainConfig()
    state = tstep.init_train_state(cfg, tt, model_from_params(cfg, params,
                                                              "cpu"))
    got = analyze(tstep.make_train_step(cfg, tt), state,
                  {k: torch.tensor(x) for k, x in rows.items()})
    return cfg, got, want


@pytest.mark.parametrize("mode", ["none", "full", "dots"])
def test_train_step_matmul_flops_match_reference(mode):
    cfg, got, want = _train_counts(mode)
    matmuls = sum(v["flops"] for k, v in got["by_op"].items()
                  if k in ("aten.mm", "aten.addmm", "aten.bmm",
                           "aten.baddbmm"))
    assert matmuls == got["flops"]
    # the probabilities times v, one (B, H, S, S) x (B, H, S, dv) product
    # a layer: recomputed by the port, not by the reference's HLO
    pv = 2 * B * cfg.n_heads * S * S * cfg.dh
    gap = 0 if mode == "none" else cfg.n_layers * pv
    assert got["flops"] - want == gap
    assert gap <= 0.01 * want


def test_recompute_shows_in_both_counts():
    """``"full"`` recomputes every layer's forward in both packages:
    each counts more than under ``"none"``, by about a forward's matmuls."""
    _, none, want_none = _train_counts("none")
    _, full, want_full = _train_counts("full")
    assert full["flops"] > 1.2 * none["flops"]
    assert want_full > 1.2 * want_none
