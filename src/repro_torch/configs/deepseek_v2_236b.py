"""DeepSeek-V2 236B [arXiv:2405.04434]: MLA + 160-expert top-6 MoE.

MLA: kv_lora=512, q_lora=1536, qk 128 nope + 64 rope, v 128. First layer is
a dense FFN (12288), layers 1..59 are MoE with 2 shared + 160 routed experts
of d_ff 1536.
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288, vocab=102_400,
    attn_type="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_dim=128, qk_rope_dim=64, v_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2,
                  router="flow", every=1),
    n_dense_prefix=1,
    mlp_act="silu", gated_mlp=True,
    rope_theta=10_000.0, sub_quadratic=False,
    source="arXiv:2405.04434 (hf)",
))
