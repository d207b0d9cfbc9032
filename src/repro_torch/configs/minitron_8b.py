"""Minitron-8B [arXiv:2407.14679]: pruned Nemotron (squared-ReLU, GQA)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab=256_000, head_dim=128,
    mlp_act="relu2", gated_mlp=False, norm="layernorm",
    rope_theta=10_000.0, sub_quadratic=False,
    source="arXiv:2407.14679 (hf)",
))
