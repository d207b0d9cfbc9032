"""Mamba2-370M [arXiv:2405.21060]: attention-free SSD. Runs long_500k."""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50_280, attn_type="none",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    tie_embeddings=True, rope_theta=0.0, sub_quadratic=True,
    source="arXiv:2405.21060 (unverified)",
))
