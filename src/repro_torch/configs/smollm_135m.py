"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M]: llama-arch small, GQA kv=3."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    d_ff=1536, vocab=49_152, head_dim=64,
    mlp_act="silu", gated_mlp=True, tie_embeddings=True,
    rope_theta=10_000.0, sub_quadratic=False,
    source="hf:HuggingFaceTB/SmolLM-135M",
))
