"""Carry problems and states between the JAX package and the port.

The port's counterpart of carrying weights across. The JAX package's
named tuples and the port's share names, field names and leaf layouts
(grid max-flow: ``GridProblem``, ``GridFlowState``, ``GridFlowResult``;
assignment: ``AssignmentResult``, ``_RefineState``, ``_ScaleState``;
matching: ``MatchingResult``, ``MatchState``), so a structure, nested
ones included, crosses leaf by leaf:

* ``to_torch`` takes a (named) tuple whose leaves are numpy arrays or
  anything ``np.asarray`` reads (a JAX array, say) and builds the port's
  structure of the same name on a device, every leaf with the same shape
  and dtype, so an internal-layout state stays internal (``cap``
  ``(4, ..., H, W)``) and a public one public (``cap`` ``(B, 4, H, W)``);
* ``to_numpy`` turns any such structure, the port's or the JAX
  package's, into a dict of numpy arrays under the field names.

Model weights cross the same way:

* ``numpy_params`` builds the JAX package's ``init_model`` params tree
  (nested dicts, ``body`` leaves stacked on a leading period axis) as
  numpy arrays from a seed, with the JAX init's standard deviations, so
  the JAX package, the port and ``chip_smoke.py`` can all start from the
  same weights;
* ``load_params`` copies such a tree (numpy or JAX leaves) into the
  port's ``Model``, unstacking ``body`` into per-layer blocks and
  transposing each ``x @ W`` matrix into its ``nn.Linear`` (the
  encoder's ``frontend``, an MoE's ``gate`` and ``shared`` MLP, MLA's
  ``wq_a``, ``wq_b``, ``wkv_a`` and ``wo``, mamba's ``in_proj`` and
  ``out_proj`` too); the 3-D tensors keep
  the JAX layout and are copied as they are: the MoE's experts ``w1``,
  ``w2``, ``w3`` and MLA's ``wk_b``, ``wv_b``; so are mamba's ``conv_w``
  ``(d_conv, di + 2 N)`` and its vectors; ``model_from_params`` builds the
  model and loads it;
* ``params_tree`` is the inverse of ``load_params``: the model's
  parameters, or any tensors keyed by its parameter names (their
  ``.grad``, an ``OptState``'s unquantized ``m`` or ``v``), as a JAX
  params tree of numpy arrays (``nn.Linear`` weights transposed back,
  ``body`` stacked over the periods), so the tests compare gradients and
  moments with the JAX package's leaf by leaf.

Imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.assignment import cost_scaling
from repro_torch.core.matching import bfs
from repro_torch.core.maxflow import grid
from repro_torch.models.layers import dense_std, depth_scaled_std
from repro_torch.models.model import Model, layer_plan, plan_period

_TYPES = {t.__name__: t for t in (
    grid.GridProblem, grid.GridFlowState, grid.GridFlowResult,
    cost_scaling.AssignmentResult, cost_scaling._RefineState,
    cost_scaling._ScaleState, bfs.MatchingResult, bfs.MatchState)}


def _leaf_to_torch(x, device: torch.device) -> torch.Tensor:
    return torch.tensor(np.array(x, copy=True), device=device)


def to_torch(tree, device=None):
    """The port's counterpart of ``tree`` on ``device`` (default cuda).

    Named tuples map to the port's class of the same name (see the module
    note), nested ones too; ``None`` leaves stay ``None``.
    """
    dev = resolve_device(device)
    if tree is None:
        return None
    if isinstance(tree, tuple):
        leaves = [to_torch(x, dev) for x in tree]
        name = type(tree).__name__
        if hasattr(tree, "_fields"):
            if name not in _TYPES:
                raise TypeError(f"no port counterpart for {name}")
            return _TYPES[name](*leaves)
        return tuple(leaves)
    return _leaf_to_torch(tree, dev)


def _leaf_to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_numpy(tree):
    """A dict of numpy arrays under the field names (nested for nested
    named tuples, ``None`` kept), for a structure of either package."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return {k: to_numpy(v) for k, v in zip(tree._fields, tree)}
    return _leaf_to_numpy(tree)


# ---------------------------------------------------------------------------
# Model weights
# ---------------------------------------------------------------------------

def _mlp_tree(cfg, normal, d_ff: int) -> dict:
    """``init_mlp``'s leaves: ``w1``, ``w2`` and, gated, ``w3``."""
    D = cfg.d_model
    ffn = {"w1": normal((D, d_ff), dense_std(D)),
           "w2": normal((d_ff, D), depth_scaled_std(d_ff, cfg.n_layers))}
    if cfg.gated_mlp:
        ffn["w3"] = normal((D, d_ff), dense_std(D))
    return ffn


def _moe_tree(cfg, normal) -> dict:
    """``init_moe``'s leaves, with its stds: ``ParamFactory.dense`` takes
    ``fan_in = shape[0]``, so the expert ``w1`` and ``w3`` ``(E, D, F)``
    get ``E ** -0.5``."""
    e, D = cfg.moe, cfg.d_model
    E, F = e.n_experts, e.d_ff_expert
    ffn = {"gate": normal((D, E), dense_std(D)),
           "w1": normal((E, D, F), dense_std(E)),
           "w2": normal((E, F, D), depth_scaled_std(F, cfg.n_layers))}
    if cfg.gated_mlp:
        ffn["w3"] = normal((E, D, F), dense_std(E))
    if e.n_shared:
        ffn["shared"] = _mlp_tree(cfg, normal, F * e.n_shared)
    return ffn


def _mla_tree(cfg, normal, ones) -> dict:
    """``init_mla``'s leaves, with its stds (``fan_in = shape[0]``: the
    3-D ``wk_b`` and ``wv_b`` get ``kv_lora ** -0.5``)."""
    m, D, H = cfg.mla, cfg.d_model, cfg.n_heads
    qd = m.qk_nope_dim + m.qk_rope_dim
    return {"wq_a": normal((D, m.q_lora_rank), dense_std(D)),
            "q_norm": ones((m.q_lora_rank,)),
            "wq_b": normal((m.q_lora_rank, H * qd),
                           dense_std(m.q_lora_rank)),
            "wkv_a": normal((D, m.kv_lora_rank + m.qk_rope_dim),
                            dense_std(D)),
            "kv_norm": ones((m.kv_lora_rank,)),
            "wk_b": normal((m.kv_lora_rank, H, m.qk_nope_dim),
                           dense_std(m.kv_lora_rank)),
            "wv_b": normal((m.kv_lora_rank, H, m.v_dim),
                           dense_std(m.kv_lora_rank)),
            "wo": normal((H * m.v_dim, D),
                         depth_scaled_std(H * m.v_dim, cfg.n_layers))}


def _mamba_tree(cfg, normal, ones, zeros) -> dict:
    """``init_mamba``'s leaves, in its order, with its stds (``scale``
    replaces the fan-in std: ``conv_w`` ``d_conv ** -0.5``, ``out_proj``
    depth-scaled) and its exact ones and zeros."""
    s, D = cfg.ssm, cfg.d_model
    di, N, H = s.d_inner(D), s.d_state, s.n_heads(D)
    return {"in_proj": normal((D, 2 * di + 2 * N + H), dense_std(D)),
            "conv_w": normal((s.d_conv, di + 2 * N), s.d_conv ** -0.5),
            "conv_b": zeros((di + 2 * N,)),
            "A_log": ones((H,)),
            "dt_bias": zeros((H,)),
            "D": ones((H,)),
            "norm_g": ones((di,)),
            "out_proj": normal((di, D), depth_scaled_std(di, cfg.n_layers))}


def _sublayer_tree(cfg, spec, normal, ones, zeros) -> dict:
    """One sublayer of the JAX params tree (``_init_sublayer``'s keys)."""
    D, H, KV, dh, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh,
                       cfg.d_ff)

    def norm():
        p = {"g": ones((D,))}
        if cfg.norm == "layernorm":
            p["b"] = zeros((D,))
        return p

    if spec[0] == "mamba":
        mixer = _mamba_tree(cfg, normal, ones, zeros)
    elif cfg.attn_type == "mla":
        mixer = _mla_tree(cfg, normal, ones)
    else:
        mixer = {"wq": normal((D, H * dh), dense_std(D)),
                 "wk": normal((D, KV * dh), dense_std(D)),
                 "wv": normal((D, KV * dh), dense_std(D)),
                 "wo": normal((H * dh, D),
                              depth_scaled_std(H * dh, cfg.n_layers))}
        if cfg.qk_norm:
            mixer["q_g"] = ones((dh,))
            mixer["k_g"] = ones((dh,))
    p = {"norm1": norm(), "mixer": mixer}
    if spec[1]:
        p["norm2"] = norm()
        p["ffn"] = (_moe_tree(cfg, normal) if spec[1] == "moe"
                    else _mlp_tree(cfg, normal, F))
    return p


def numpy_params(cfg, seed: int = 0) -> dict:
    """The JAX ``init_model(cfg, ...)[0]`` tree as float32 numpy arrays
    drawn from ``np.random.default_rng(seed)``, with its stds (the
    numbers are numpy's, not ``jax.random``'s). ``body`` leaves carry the
    leading ``n_periods`` axis. ``frontend`` is drawn after every other
    leaf, so the configs without one get the same numbers as before it
    was ported."""
    rng = np.random.default_rng(seed)
    plan = layer_plan(cfg)
    period = plan_period(cfg)
    n_pre = cfg.n_dense_prefix
    n_periods = (cfg.n_layers - n_pre) // period

    def maker(lead):
        def normal(shape, std):
            x = rng.standard_normal(lead + shape, dtype=np.float32)
            x *= np.float32(std)
            return x
        return (normal, lambda shape: np.ones(lead + shape, np.float32),
                lambda shape: np.zeros(lead + shape, np.float32))

    one = maker(())
    tree = {"embed": one[0]((cfg.vocab, cfg.d_model),
                            cfg.d_model ** -0.5),
            "prefix": [_sublayer_tree(cfg, plan[i], *one)
                       for i in range(n_pre)],
            "body": {f"sub{j}": _sublayer_tree(cfg, plan[n_pre + j],
                                               *maker((n_periods,)))
                     for j in range(period)},
            "final_norm": {"g": one[1]((cfg.d_model,))}}
    if cfg.norm == "layernorm":
        tree["final_norm"]["b"] = one[2]((cfg.d_model,))
    if not cfg.tie_embeddings:
        tree["lm_head"] = one[0]((cfg.d_model, cfg.vocab),
                                 dense_std(cfg.d_model))
    if cfg.frontend_dim:
        tree["frontend"] = one[0]((cfg.frontend_dim, cfg.d_model),
                                  dense_std(cfg.frontend_dim))
    return tree


def _matrix(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).T))


def _vector(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _as_is(x) -> torch.Tensor:
    """A leaf in the JAX layout (no copy where numpy's is writable)."""
    return torch.from_numpy(np.require(x, requirements=["C", "W"]))


def _linears(prefix: str, tree: dict) -> dict:
    """x @ W in JAX, W.T in nn.Linear."""
    return {f"{prefix}.{k}.weight": _matrix(x) for k, x in tree.items()}


# mixer leaves copied in the JAX layout: the gains, and mamba's conv and
# vectors (every other mixer matrix is an nn.Linear's, transposed)
_MIXER_AS_IS = ("q_g", "k_g", "q_norm", "kv_norm", "conv_w", "conv_b",
                "A_log", "dt_bias", "D", "norm_g")


def _sublayer_state(prefix: str, tree: dict) -> dict:
    sd = {}
    for norm in ("norm1", "norm2"):
        for k, x in tree.get(norm, {}).items():
            sd[f"{prefix}.{norm}.{k}"] = _vector(x)
    for k, x in tree["mixer"].items():
        if k in _MIXER_AS_IS:
            sd[f"{prefix}.mixer.{k}"] = _vector(x)
        elif k in ("wk_b", "wv_b"):     # MLA's (kv_lora, H, ·), the JAX layout
            sd[f"{prefix}.mixer.{k}"] = _as_is(x)
        else:
            sd[f"{prefix}.mixer.{k}.weight"] = _matrix(x)
    ffn = tree.get("ffn", {})
    if "gate" in ffn:       # MoE: only the gate and shared MLP transpose
        sd[f"{prefix}.ffn.gate.weight"] = _matrix(ffn["gate"])
        for k in ("w1", "w2", "w3"):
            if k in ffn:    # (E, D, F) / (E, F, D), the JAX layout
                sd[f"{prefix}.ffn.{k}"] = _as_is(ffn[k])
        if "shared" in ffn:
            sd.update(_linears(f"{prefix}.ffn.shared", ffn["shared"]))
    else:
        sd.update(_linears(f"{prefix}.ffn", ffn))
    return sd


def _at(tree, r: int):
    """Index ``r`` of every leaf's leading axis, nested dicts kept."""
    if isinstance(tree, dict):
        return {k: _at(x, r) for k, x in tree.items()}
    return np.asarray(tree)[r]


def load_params(model: Model, params: dict) -> Model:
    """Copy a JAX ``init_model`` params tree (numpy or JAX leaves) into
    ``model``, every tensor checked by ``load_state_dict(strict=True)``.
    Layer ``n_dense_prefix + r * period + j`` takes ``body["sub{j}"]`` at
    index ``r`` of its leading axis. Returns ``model``."""
    cfg = model.cfg
    period = plan_period(cfg)
    n_pre = cfg.n_dense_prefix
    sd = {"embed": _vector(params["embed"])}
    for i, tree in enumerate(params["prefix"]):
        sd.update(_sublayer_state(f"layers.{i}", tree))
    n_periods = (cfg.n_layers - n_pre) // period
    for r in range(n_periods):
        for j in range(period):
            sd.update(_sublayer_state(f"layers.{n_pre + r * period + j}",
                                      _at(params["body"][f"sub{j}"], r)))
    for k, x in params["final_norm"].items():
        sd[f"final_norm.{k}"] = _vector(x)
    for k in ("lm_head", "frontend"):
        if k in params:
            sd[f"{k}.weight"] = _matrix(params[k])
    with torch.no_grad():
        model.load_state_dict(sd, strict=True)
    return model


def model_from_params(cfg, params: dict, device=None) -> Model:
    """The port's ``Model`` holding a JAX-layout params tree's weights, on
    ``device`` (default cuda), in the tree's dtype."""
    dtype = torch.from_numpy(np.asarray(params["embed"][:1])).dtype
    return load_params(Model(cfg, device=device, dtype=dtype), params)


def _numpy_leaf(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_tree(model: Model, values: dict | None = None) -> dict:
    """The inverse of ``load_params``: ``values`` (default: the model's
    parameters), keyed by the model's parameter names, as the JAX
    ``init_model`` params tree of numpy arrays. Each ``nn.Linear`` weight
    (a name ending in ``.weight``) is transposed back to the JAX ``x @ W``
    matrix, every other tensor kept in its (the JAX) layout; layer
    ``n_dense_prefix + r * period + j`` goes to index ``r`` of
    ``body["sub{j}"]``'s leading axis, the layers before it to ``prefix``.
    bfloat16 tensors come back as float32."""
    cfg = model.cfg
    if values is None:
        values = dict(model.named_parameters())
    if values.keys() != dict(model.named_parameters()).keys():
        raise ValueError("values must be keyed by the model's parameter "
                         "names")
    period = plan_period(cfg)
    n_pre = cfg.n_dense_prefix
    tree: dict = {"prefix": [{} for _ in range(n_pre)]}
    stacks: dict = {}               # (j, path) -> [leaf per period]

    def put(node: dict, path: list, leaf):
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf

    for name, t in values.items():
        path = name.split(".")
        leaf = _numpy_leaf(t)
        if path[-1] == "weight":
            path, leaf = path[:-1], np.ascontiguousarray(leaf.T)
        if path[0] != "layers":
            put(tree, path, leaf)
            continue
        i, rest = int(path[1]), path[2:]
        if i < n_pre:
            put(tree["prefix"][i], rest, leaf)
        else:
            j = (i - n_pre) % period
            stacks.setdefault((j, tuple(rest)), []).append(leaf)
    body = tree.setdefault("body", {})
    for (j, rest), leaves in stacks.items():
        put(body.setdefault(f"sub{j}", {}), list(rest), np.stack(leaves))
    return tree
