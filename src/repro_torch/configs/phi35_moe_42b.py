"""Phi-3.5-MoE 42B (6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.configs.base import MoEConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab=32_064, head_dim=128,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400,
                  router="flow", every=1),
    mlp_act="silu", gated_mlp=True, norm="layernorm",
    rope_theta=10_000.0, sub_quadratic=False,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
))
