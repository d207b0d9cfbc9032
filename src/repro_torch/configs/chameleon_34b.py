"""Chameleon-34B [arXiv:2405.09818]: early-fusion VLM, VQ image tokens.

The image frontend (VQ-GAN tokenizer) is a STUB: images arrive as discrete
tokens inside the shared 65536 vocab, so the backbone is a plain decoder
with qk-norm. long_500k skipped: pure quadratic full attention.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=65_536, head_dim=128,
    mlp_act="silu", gated_mlp=True, qk_norm=True,
    rope_theta=10_000.0, sub_quadratic=False,
    source="arXiv:2405.09818 (unverified)",
))
