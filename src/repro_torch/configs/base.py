"""Architecture config dataclass + registry (``--arch <id>`` everywhere).

The port's own copy of ``repro/configs/base.py`` (pure data, no JAX), so
that ``repro_torch`` imports nothing of ``repro``; the config modules
beside it are copies too, and ``list_configs()`` equals the JAX
package's. The port's model runs every family and option here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

_REGISTRY: dict[str, "ModelConfig"] = {}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    router: str = "topk"          # "topk" | "flow" (paper technique)
    capacity_factor: float = 1.25
    every: int = 1                # MoE layer every `every` layers
    router_iters: int = 8         # auction rounds for router="flow"


@dataclasses.dataclass(frozen=True)
class MLAConfig:                  # DeepSeek multi-head latent attention
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:                  # Mamba2 SSD
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    head_dim: int = 0             # 0 -> d_model // n_heads
    attn_type: str = "gqa"        # gqa | mla | none
    mlp_act: str = "silu"         # silu (=> SwiGLU) | relu2 | gelu
    gated_mlp: bool = True
    norm: str = "rmsnorm"
    causal: bool = True
    tie_embeddings: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    max_seq: int = 524_288
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_period: int = 1          # hybrid: attention layer every `period`
    n_dense_prefix: int = 0       # leading dense-FFN layers (deepseek: 1)
    frontend_dim: int = 0         # audio/vlm stubs: input embedding width
    sub_quadratic: bool = False   # can run long_500k
    remat: str = "full"           # full | dots | none
    kv_quant: bool = False        # int8 KV cache (GQA decode memory /2)
    # paper notes / provenance
    source: str = ""

    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def param_count(self) -> int:
        """Approximate parameter count (reported in DESIGN/EXPERIMENTS)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        emb = V * D * (1 if self.tie_embeddings else 2)
        n = emb
        for i in range(L):
            n += self._layer_params(i)
        return n

    def _layer_params(self, i: int) -> int:
        D, F = self.d_model, self.d_ff
        n = 2 * D                                      # norms
        is_attn = (i % self.attn_period == 0) if self.family == "hybrid" \
            else (self.attn_type != "none")
        if self.family == "ssm" or (self.family == "hybrid" and not is_attn):
            s = self.ssm
            di = s.d_inner(D)
            n += D * (2 * di + 2 * s.d_state + s.n_heads(D)) + di * D \
                + s.d_conv * (di + 2 * s.d_state)
        elif self.attn_type == "mla":
            m = self.mla
            qd = m.qk_nope_dim + m.qk_rope_dim
            n += D * m.q_lora_rank + m.q_lora_rank * self.n_heads * qd
            n += D * (m.kv_lora_rank + m.qk_rope_dim)
            n += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_dim)
            n += self.n_heads * m.v_dim * D
        elif self.attn_type != "none":
            dh = self.dh
            n += D * self.n_heads * dh + 2 * D * self.n_kv_heads * dh \
                + self.n_heads * dh * D
        # FFN / MoE
        moe_here = self.moe is not None and i >= self.n_dense_prefix and \
            ((i - self.n_dense_prefix) % self.moe.every == 0)
        if moe_here:
            e = self.moe
            per = D * e.d_ff_expert * (3 if self.gated_mlp else 2)
            n += (e.n_experts + e.n_shared) * per + D * e.n_experts
        elif F:
            n += D * F * (3 if self.gated_mlp else 2)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        D, L = self.d_model, self.n_layers
        n = self.vocab * D * (1 if self.tie_embeddings else 2)
        e = self.moe
        for i in range(L):
            full = self._layer_params(i)
            moe_here = i >= self.n_dense_prefix and \
                ((i - self.n_dense_prefix) % e.every == 0)
            if moe_here:
                per = D * e.d_ff_expert * (3 if self.gated_mlp else 2)
                full -= (e.n_experts - e.top_k) * per
            n += full
        return n


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        import repro_torch.configs.all  # noqa: F401 (registers everything)
    return _REGISTRY[name]


def list_configs() -> list[str]:
    import repro_torch.configs.all  # noqa: F401
    return sorted(_REGISTRY)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw: dict = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family != "hybrid"
                     else 2 * cfg.attn_period),
        d_model=128, d_ff=256 if cfg.d_ff else 0, vocab=128,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=32 if cfg.n_heads else 0, max_seq=512,
        name=cfg.name + "-smoke")
    if cfg.n_kv_heads == cfg.n_heads:       # MHA archs stay MHA
        kw["n_kv_heads"] = kw["n_heads"]
    if cfg.moe:
        # slack capacity: at smoke scale, tight capacity makes routing
        # depend on batch composition (full-vs-prefill token sets differ),
        # which breaks decode-consistency tests for reasons inherent to
        # capacity-routed MoE, not bugs. Production cf stays 1.25.
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64, capacity_factor=2.5)
    if cfg.mla:
        kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                              qk_nope_dim=16, qk_rope_dim=16, v_dim=16)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=32,
                                        chunk=64)
    return dataclasses.replace(cfg, **kw)
