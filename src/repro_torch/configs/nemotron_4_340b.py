"""Nemotron-4-340B [arXiv:2402.16819]: dense GQA, squared-ReLU MLP."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab=256_000, head_dim=192,
    mlp_act="relu2", gated_mlp=False,        # squared-ReLU, ungated
    norm="layernorm",                        # nemotron uses LayerNorm
    rope_theta=10_000.0, sub_quadratic=False,
    source="arXiv:2402.16819 (unverified)",
))
