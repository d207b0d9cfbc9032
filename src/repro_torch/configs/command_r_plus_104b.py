"""Command-R+ 104B [hf:CohereForAI]: dense GQA, no-bias, tied embeddings."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab=256_000, head_dim=128,
    mlp_act="silu", gated_mlp=True, tie_embeddings=True,
    norm="layernorm", qk_norm=True,          # cohere uses qk-norm (R+)
    rope_theta=75_000_000.0, sub_quadratic=False,
    source="hf:CohereForAI/c4ai-command-r-plus (unverified)",
))
