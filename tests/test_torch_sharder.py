"""The port's placements against the reference's ``Sharder``.

For every parameter of all 10 archs at full size (built on ``meta``), on
the 16 x 16 and 2 x 16 x 16 production meshes, the port's spec
(``repro_torch.models.layers.Sharder.spec`` of the port's logical axes,
``models.model.param_axes``) equals the reference ``Sharder(stub).spec``
of the matching JAX leaf exactly: ``nn.Linear`` weights are the JAX
matrices transposed, so their specs are read reversed, and the body's
stacked period axis (always replicated) is dropped. ``stub`` is an
object with a ``.shape`` dict, which is all the reference's ``_axes``
reads. The same holds for every cache leaf and for the AdamW moments.
The rule that replicates a dim the mesh axes do not divide (smollm's 9
heads on a 16-way model axis) comes with it.
"""
import functools
import types

import jax
import pytest

from repro.configs.base import get_config as jax_get_config
from repro.launch import specs as jspecs
from repro.models import model as jmodel
from repro.models.layers import Sharder as JSharder
from repro.train import step as jstep
from repro_torch.configs.base import get_config
from repro_torch.launch.dryrun import LM_ARCHS
from repro_torch.launch.specs import (_opt_moment_specs, _tree_specs,
                                      cache_axes_of, model_axes)
from repro_torch.models.layers import DEFAULT_RULES, Sharder
from repro_torch.models.model import Model, init_caches, plan_period
from repro_torch.optim.adamw import (AdamWConfig, Quantized, init_opt_state,
                                     moment_spec, on_moment)

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
CACHE_B, CACHE_S = 128, 32768       # decode_32k


def _sharders(mesh):
    sizes = MESHES[mesh]
    stub = types.SimpleNamespace(mesh_dim_names=tuple(sizes),
                                 shape=tuple(sizes.values()))
    return (Sharder(stub, DEFAULT_RULES),
            JSharder(types.SimpleNamespace(shape=dict(sizes)), DEFAULT_RULES))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = jax_get_config(arch)
    shapes = jax.eval_shape(lambda k: jmodel.init_model(cfg, k)[0],
                            jax.random.PRNGKey(0))
    return shapes, jspecs.model_axes(cfg)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _jax_leaf(cfg, name):
    """The JAX path of a port parameter, whether its layout is the JAX
    one transposed (an ``nn.Linear`` weight) and whether it lies in the
    stacked body."""
    parts = name.split(".")
    transposed = parts[-1] == "weight"
    if transposed:
        parts = parts[:-1]
    if parts[0] != "layers":
        return parts, transposed, False
    i, rest = int(parts[1]), parts[2:]
    if i < cfg.n_dense_prefix:
        return ["prefix", i, *rest], transposed, False
    j = (i - cfg.n_dense_prefix) % plan_period(cfg)
    return ["body", f"sub{j}", *rest], transposed, True


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_specs_equal_reference(arch, mesh):
    cfg = get_config(arch)
    shd, jshd = _sharders(mesh)
    shapes, jaxes = _jax_params(arch)
    model = Model(cfg, device="meta")
    axes = model_axes(cfg)
    specs = _tree_specs(shd, dict(model.named_parameters()), axes)
    assert specs.keys() == axes.keys()
    split = 0
    for name, spec in specs.items():
        path, transposed, stacked = _jax_leaf(cfg, name)
        want = tuple(jshd.spec(_at(shapes, path).shape, _at(jaxes, path)))
        if stacked:
            assert want[0] is None
            want = want[1:]
        got = tuple(reversed(spec)) if transposed else spec
        assert got == want, (name, got, want)
        split += any(e is not None for e in spec)
    assert split > 0


def test_indivisible_dims_replicate():
    """smollm's 9 heads do not divide a 16-way model axis; their 576
    columns do; 3 kv heads of 64 (192 columns) do as well."""
    shd, jshd = _sharders("16x16")
    assert shd.spec((8, 1024, 9, 64), ("batch", None, "tp", None)) \
        == (None, None, None, None)
    assert shd.spec((32, 576), ("batch", "tp")) == ("data", "model")
    assert shd.spec((576, 192), ("fsdp", "tp")) == ("data", "model")
    assert shd.spec((49152, 576), ("tp", "fsdp")) == ("model", "data")
    assert shd.spec((3, 5), ("fsdp", "tp")) == (None, None)
    pod = _sharders("2x16x16")[0]
    assert pod.spec((64, 8), ("batch", None)) == (("pod", "data"), None)
    assert pod.spec((16, 8), ("batch", None)) == (None, None)
    assert (shd.data_groups, pod.data_groups) == (16, 32)
    assert (jshd.data_groups, _sharders("2x16x16")[1].data_groups) == (16, 32)
    assert Sharder().data_groups == 1


@functools.lru_cache(maxsize=None)
def _jax_caches(arch):
    cfg = jax_get_config(arch)
    shapes = jax.eval_shape(lambda: jmodel.init_caches(
        cfg, CACHE_B, CACHE_S)[0])
    return shapes, jspecs.cache_axes_of(cfg)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cache_specs_equal_reference(arch, mesh):
    cfg = get_config(arch)
    shd, jshd = _sharders(mesh)
    shapes, jaxes = _jax_caches(arch)
    caches = init_caches(cfg, CACHE_B, CACHE_S, device="meta")
    for i, (cache, axes) in enumerate(zip(caches, cache_axes_of(cfg))):
        if i < cfg.n_dense_prefix:
            jc, ja, stacked = shapes["prefix"][i], jaxes["prefix"][i], False
        else:
            j = (i - cfg.n_dense_prefix) % plan_period(cfg)
            jc, ja, stacked = shapes["body"][j], jaxes["body"][j], True
        assert type(cache).__name__ == type(jc).__name__
        for leaf, a, jleaf, jaxis in zip(cache, axes, jc, ja):
            got = shd.spec(leaf.shape, a)
            want = tuple(jshd.spec(jleaf.shape, jaxis))
            assert got == (want[1:] if stacked else want), (i, got, want)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_moment_specs_equal_reference(arch):
    """AdamW moments are placed like their parameters (the reference's
    ``_opt_moment_specs``, float32 moments), on the 16 x 16 mesh;
    quantized moments shard their leading dims like the parameter and
    replicate the (blocks, BLOCK) payload."""
    cfg = get_config(arch)
    shd, jshd = _sharders("16x16")
    shapes, jaxes = _jax_params(arch)
    jstate = jax.eval_shape(lambda p: jstep.init_train_state(
        jax_get_config(arch), jstep.TrainConfig(), p), shapes)
    jm = jspecs._opt_moment_specs(jshd, jstate.opt.m, jaxes)
    model = Model(cfg, device="meta")
    axes = model_axes(cfg)
    params = dict(model.named_parameters())
    m = init_opt_state(AdamWConfig(), params).m
    got = _opt_moment_specs(shd, m, axes)
    for name, spec in got.items():
        path, transposed, stacked = _jax_leaf(cfg, name)
        want = tuple(_at(jm, path))
        want = want[1:] if stacked else want
        assert (tuple(reversed(spec)) if transposed else spec) == want, name
    q = init_opt_state(AdamWConfig(quantize_moments=True), params).m
    for name, spec in _opt_moment_specs(shd, q, axes).items():
        p_spec = shd.spec(params[name].shape, axes[name])
        # the placement the port's optimizer keeps its moments in
        quantized = isinstance(q[name], Quantized)
        ms = moment_spec(p_spec, quantized, whole=False)
        assert on_moment(lambda t, sp: sp, q[name], ms) == spec, name
        assert moment_spec(p_spec, quantized, whole=True) \
            == (None,) * len(p_spec)
        if isinstance(spec, Quantized):
            assert spec.q[:-2] == p_spec[:-1] and spec.q[-2:] == (None, None)
            assert spec.scale[:-2] == p_spec[:-1]
        else:
            assert spec == p_spec
