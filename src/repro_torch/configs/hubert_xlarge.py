"""HuBERT-XLarge [arXiv:2106.07447]: encoder-only audio transformer.

The conv waveform frontend is a STUB: ``input_specs()`` provides precomputed
512-dim frame embeddings (the conv extractor's output width); the model
projects them to d_model. vocab=504 is the k-means codebook (masked-frame
prediction targets). Encoder-only: no decode shapes.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab=504, head_dim=80,
    mlp_act="gelu", gated_mlp=False, norm="layernorm",
    causal=False, rope_theta=0.0,            # conv-pos stub -> sinusoidal
    frontend_dim=512, sub_quadratic=False,
    source="arXiv:2106.07447 (unverified)",
))
