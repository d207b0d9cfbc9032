"""Roofline terms of a counted step on one NVIDIA H100.

Counterpart of ``repro/roofline.py``. Three terms per (arch x shape x
card), in seconds:

    compute    = FLOPs / the card's peak for the cell's dtype
    memory     = bytes moved / 3.35 TB/s HBM
    collective = collective bytes / the link rate per card (``link_bw``)

The counts come from ``roofline_hlo.analyze``, which runs the step once
under a dispatch mode: FLOPs of the matmuls and K6, bytes at every op
boundary, the output bytes of each collective (none on one card); on a
mesh they are rank 0's, one card's share of the step. The peaks are one
H100 SXM's published rates: 989 TFLOP/s dense bf16 on the tensor cores
and 67 TFLOP/s float32 off them (the port runs its float32 matmuls with
TF32 off). The link rate: within a node of 8 cards, NVLink 4 at 450 GB/s
each way (900 GB/s both ways, NVIDIA's H100 SXM data sheet); a mesh of
more cards spans nodes, and every group of the production meshes (16
consecutive ranks along ``model``, 16 at a stride along ``data``)
crosses them, so there the rate is the fabric's per card, assumed to be
the DGX H100 / SuperPOD layout of one 400 Gb/s NDR InfiniBand port per
card: 50 GB/s each way. The reference's ``cost_analysis_dict`` normalises the return value
of XLA's ``compiled.cost_analysis()`` across JAX versions; the port
compiles nothing, so it has no counterpart.

The module also owns K6's work count (``flash_attention_work``): the
causal pairs, ``2 * dh + 2 * dv`` flops per pair, q, k and v read once
and the output (and, where asked, the log-sum-exp) written once. The
kernel registers it as its flop formula, and ``chip_smoke.py`` takes its
bounds from it.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}   # H100 SXM, dense
HBM_BW = 3.35e12            # bytes/s
LINK_BW = 450e9             # bytes/s, NVLink each way (within a node)
NET_BW = 50e9               # bytes/s each way per card between nodes
NODE_CARDS = 8


def link_bw(chips: int) -> float:
    """The link rate per card a step of ``chips`` cards is bound by:
    NVLink within a node, the fabric across nodes."""
    return LINK_BW if chips <= NODE_CARDS else NET_BW


def causal_pairs(Sq: int, Sk: int) -> int:
    """(query, key) pairs with ``pos_q >= pos_k``, both from 0: the sum
    over queries ``i`` of ``min(i + 1, Sk)``."""
    n = min(Sq, Sk)
    return n * (n + 1) // 2 + max(Sq - Sk, 0) * Sk


def flash_attention_work(B: int, Sq: int, Sk: int, H: int, KV: int,
                         dh: int, dv: int, *, causal: bool, itemsize: int,
                         lse: bool = False) -> tuple[int, int, int]:
    """K6's ``(pairs, flops, bytes)`` for q ``(B, Sq, H, dh)``, k ``(B, Sk,
    KV, dh)`` and v ``(B, Sk, KV, dv)`` of ``itemsize`` bytes: ``2 * dh``
    flops for a score and ``2 * dv`` for its share of the output per
    (query, key) pair that the mask keeps; q, k, v read once and the
    output written once, with ``lse`` also the float32 ``(B, H, Sq)``
    log-sum-exp."""
    pairs = B * H * (causal_pairs(Sq, Sk) if causal else Sq * Sk)
    nbytes = itemsize * (B * Sq * H * (dh + dv) + B * Sk * KV * (dh + dv))
    if lse:
        nbytes += 4 * B * H * Sq
    return pairs, pairs * (2 * dh + 2 * dv), nbytes


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float
    bytes_accessed: float
    coll_bytes: float
    coll_breakdown: dict
    model_flops: float          # 6·N_active·tokens (theory)
    bytes_per_chip: float       # predicted peak device memory per card
    dtype: str = "bf16"         # the cell's compute dtype: PEAK_FLOPS key

    # flops / bytes / coll_bytes are per-card quantities, as the
    # reference's per-device SPMD program's
    @property
    def peak_flops(self) -> float:
        return PEAK_FLOPS[self.dtype]

    @property
    def t_compute(self):
        return self.flops / self.peak_flops

    @property
    def t_memory(self):
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self):
        return self.coll_bytes / link_bw(self.chips)

    @property
    def t_step(self):
        """The least time of the step: the largest term."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bottleneck(self):
        t = {"compute": self.t_compute, "memory": self.t_memory,
             "collective": self.t_collective}
        return max(t, key=t.get)

    @property
    def useful_flops_frac(self):
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_frac(self):
        """Fraction of the compute roofline the step achieves if every term
        overlaps perfectly: model_flops time / max(all terms)."""
        t_model = self.model_flops / (self.chips * self.peak_flops)
        t_step = self.t_step
        return t_model / t_step if t_step else 0.0

    def row(self):
        return (f"| {self.arch} | {self.shape} | {self.mesh} | "
                f"{self.t_compute*1e3:.1f} | {self.t_memory*1e3:.1f} | "
                f"{self.t_collective*1e3:.1f} | {self.bottleneck} | "
                f"{self.useful_flops_frac:.2f} | {self.roofline_frac:.2f} |")


def model_flops_for(cfg, shape_info) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) for train; 2·N for decode/prefill
    forward-only (per generated/processed token)."""
    S, B = shape_info["seq_len"], shape_info["global_batch"]
    n_active = cfg.active_param_count()
    if shape_info["kind"] == "train":
        tokens = S * B
        return 6.0 * n_active * tokens
    if shape_info["kind"] == "prefill":
        return 2.0 * n_active * S * B
    return 2.0 * n_active * B          # decode: one token per request
