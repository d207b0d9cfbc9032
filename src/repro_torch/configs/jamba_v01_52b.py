"""Jamba-v0.1 52B [arXiv:2403.19887]: Mamba+attention 1:7, 16-expert MoE.

Period of 8 layers: one attention layer per 8 (index 0 of each period in
this implementation; the released model uses index 4 — roofline-identical),
MoE every other layer. Mamba sublayers use d_state=16 (Jamba v0.1 is
Mamba-1; we realize them with the SSD block at N=16 — see DESIGN.md §2).
Sub-quadratic: runs long_500k (attention decode is linear in cache length).
"""
from repro_torch.configs.base import MoEConfig, ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65_536, head_dim=128,
    attn_period=8,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, chunk=256),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336,
                  router="flow", every=2),
    mlp_act="silu", gated_mlp=True,
    rope_theta=0.0,                          # jamba uses no positional emb
    sub_quadratic=True,
    source="arXiv:2403.19887 (hf)",
))
