"""K6's float32 arithmetic and launch geometry, on the CPU.

K6 runs float32 attention on the TF32 tensor cores, each operand split as
``x = hi + lo`` with ``hi = tf32_round(x)``, ``lo = tf32_round(x - hi)``
and summed as ``lo*hi + hi*lo + hi*hi`` (source note in
``kernels/csrc/flash_attention.cu``). The kernel itself runs only on the
card; here ``ref.attention_tf32`` models its products and is held to a
float64 oracle: within the kernel's 3e-5 tolerance with three products,
and past it with one, which is why the kernel splits. Inputs are numpy
normals from fixed seeds. ``launch_geometry`` (what the C entry launches
with, once it has checked that it fits) is checked for the shapes the
kernel is launched at:
float32 with dh, dv <= 64 on ``flash_fwd_wgmma``, the rest on
``flash_fwd_mma``.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fak
from repro_torch.kernels.flash_attention.ref import (attention_tf32,
                                                     flash_attention_ref,
                                                     tf32_round, tf32_split)

F32_TOL = 3e-5

# (B, Sq, Sk, H, KV, dh, dv), causal: the float32 shapes of chip_smoke's
# FLASH_SWEEP (the JAX kernel test's sweep) and one head at the serve
# path's 1024 keys, dh 64
SHAPES = [
    ((2, 64, 64, 4, 2, 16, 16), True),
    ((1, 128, 128, 6, 3, 32, 16), False),
    ((2, 256, 256, 8, 8, 64, 64), True),
    ((1, 64, 64, 4, 1, 16, 8), True),
    ((1, 512, 512, 2, 2, 32, 32), True),
    ((1, 1024, 1024, 1, 1, 64, 64), True),
]


def _qkv(dims, seed=0):
    B, Sq, Sk, H, KV, dh, dv = dims
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, dh)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, dh)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, dv)).astype(np.float32))


def _oracle(q, k, v, causal):
    """Dense attention in float64 with the plain version's masking."""
    q, k, v = (np.asarray(x, np.float64) for x in (q, k, v))
    Sq, H, dh = q.shape[1:]
    Sk, KV = k.shape[1:3]
    k, v = np.repeat(k, H // KV, 2), np.repeat(v, H // KV, 2)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * dh ** -0.5
    if causal:
        s = np.where(np.arange(Sq)[:, None] >= np.arange(Sk)[None, :], s,
                     -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)


def _bits(x: float) -> int:
    return int(torch.tensor([x]).view(torch.int32).item()) & 0xFFFFFFFF


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1 + 2 ** -11, 1 + 2 ** -10),            # a tie: away from zero
    (1 + 2 ** -10 + 2 ** -11, 1 + 2 ** -9),  # a tie: away from zero
    (1 + 2 ** -11 - 2 ** -23, 1.0),          # under the tie: down
    (-(1 + 2 ** -11), -(1 + 2 ** -10)),      # negative tie: away
    (-(1 + 2 ** -12), -1.0),
    (0.0, 0.0),
    (-0.0, -0.0),
    (math.inf, math.inf),
    (-math.inf, -math.inf),
    (3.4028234663852886e38, math.inf),       # float32's largest: past TF32's
    (2 ** -130, 2 ** -130),                  # subnormal, 13 low bits clear
])
def test_tf32_round_bit_patterns(x, want):
    got = tf32_round(torch.tensor([x], dtype=torch.float32))
    assert _bits(got.item()) == _bits(want)
    assert _bits(got.item()) & 0x1FFF == 0


def test_tf32_round_keeps_nan():
    assert torch.isnan(tf32_round(torch.tensor([math.nan]))).all()


def test_tf32_split_recovers_float32():
    x = torch.tensor(np.random.default_rng(1).standard_normal(4096),
                     dtype=torch.float32)
    hi, lo = tf32_split(x)
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0x1FFF == 0).all()
    # hi + lo keeps 22 of float32's 24 mantissa bits
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max().item()
    assert rel <= 2.0 ** -21


@pytest.mark.parametrize("dims,causal", SHAPES)
def test_three_tf32_products_stay_within_tolerance(dims, causal):
    q, k, v = _qkv(dims)
    got = attention_tf32(*map(torch.tensor, (q, k, v)), causal=causal)
    err = np.abs(got.numpy() - _oracle(q, k, v, causal)).max()
    assert err <= F32_TOL
    # and about as close as plain float32 (about 7e-7 here)
    plain = flash_attention_ref(*map(torch.tensor, (q, k, v)),
                                causal=causal)
    assert err <= 4 * np.abs(plain.numpy() - _oracle(q, k, v, causal)).max()


@pytest.mark.parametrize("dims,causal", SHAPES)
def test_one_tf32_product_breaks_tolerance(dims, causal):
    q, k, v = _qkv(dims)
    got = attention_tf32(*map(torch.tensor, (q, k, v)), causal=causal,
                         products=1)
    assert np.abs(got.numpy() - _oracle(q, k, v, causal)).max() > F32_TOL


def test_attention_tf32_rejects_other_product_counts():
    q, k, v = map(torch.tensor, _qkv((1, 8, 8, 2, 1, 8, 8)))
    with pytest.raises(ValueError, match="products"):
        attention_tf32(q, k, v, products=2)


# (B, Sq, H, dh, dv), dtype: the serve prefill, the head widths the kernel
# takes (8 .. 256, dh != dv), tails of Sq, both dtypes
GEOMETRY_CASES = [
    ((8, 1024, 9, 64, 64), torch.float32),
    ((8, 1024, 9, 64, 64), torch.bfloat16),
    ((2, 100, 9, 64, 64), torch.float32),
    ((1, 1000, 4, 8, 8), torch.float32),
    ((1, 1, 4, 24, 40), torch.float32),
    ((1, 130, 4, 72, 64), torch.float32),
    ((1, 96, 4, 192, 128), torch.float32),
    ((1, 96, 4, 192, 128), torch.bfloat16),
    ((1, 65, 2, 256, 256), torch.float32),
    ((1, 65, 2, 256, 256), torch.bfloat16),
    ((3, 4097, 1, 255, 1), torch.bfloat16),
]


@pytest.mark.parametrize("dims,dtype", GEOMETRY_CASES)
def test_launch_geometry_fits_the_card(dims, dtype):
    B, Sq, H, dh, dv = dims
    es = 4 if dtype == torch.float32 else 2
    g = fak.launch_geometry(B, Sq, H, dh, dv, dtype)
    assert g.smem_bytes <= fak.SMEM_MAX
    # every query row in exactly one block
    assert g.grid[0] == B * H
    assert g.grid[1] * g.block_q >= Sq > (g.grid[1] - 1) * g.block_q
    assert g.grid[1] <= fak.GRID_Y_MAX
    assert g.threads == 32 * (g.block_q // 16)    # a warp per 16 rows
    assert g.q_in_registers == (dh <= 64 and dv <= 64)
    assert g.wgmma == (g.q_in_registers and dtype == torch.float32)
    assert g.dh_pad >= dh and g.dv_pad >= dv and g.dv_pad <= g.dv_class
    assert g.block_k % 16 == 0 and g.stages >= 2
    ring = g.stages * g.block_k * (g.k_stride + g.v_stride) * es
    if g.wgmma:
        # two warpgroups of 64 rows, dh and dv padded to 64 (m64n64k8),
        # raw rows 68 floats apart, four 64 x 64 hi / lo planes
        assert (g.block_q, g.block_k, g.dh_pad, g.dv_pad) == (128, 64, 64, 64)
        assert g.k_stride == g.v_stride == 68
        assert g.smem_bytes == ring + 4 * 64 * 64 * es
        assert g.block_q * g.k_stride * es <= 4 * 64 * 64 * es  # q staging
        return
    # padding to two MMA k steps (dh) and to whole 32-column groups (dv)
    assert g.dh_pad % (16 if es == 4 else 32) == 0
    assert g.dh_pad < dh + (16 if es == 4 else 32)
    assert g.dv_pad % 32 == 0 and g.dv_pad < dv + 32
    assert g.block_k == (64 if g.q_in_registers else 32)
    # conflict-free fragment reads and 16-byte rows
    assert g.k_stride >= g.dh_pad and g.k_stride * es % 128 == 64
    assert g.v_stride >= g.dv_pad and g.v_stride * es % 64 == 16
    q_tile = g.block_q * g.k_stride * es
    if g.q_in_registers:   # q is staged in ring stage 1 before the loop
        assert q_tile <= ring // g.stages and g.smem_bytes == ring
    else:
        assert g.smem_bytes == ring + q_tile
    assert len(g.c_args()) == 11


def test_launch_geometry_at_the_serve_prefill():
    g = fak.launch_geometry(8, 1024, 9, 64, 64, torch.float32)
    assert g.wgmma and g.q_in_registers and g.threads == 256
    assert g.smem_bytes == (2 * 64 * 2 * 68 + 4 * 64 * 64) * 4 == 135168
    assert g.grid == (72, 8)
    assert g.c_args() == (1, 1, 64, 64, 64, 64, 68, 68, 135168, 72, 8)


def test_launch_geometry_bf16_serve_shape_on_mma_sync():
    g = fak.launch_geometry(8, 1024, 9, 64, 64, torch.bfloat16)
    assert not g.wgmma and g.q_in_registers and g.block_k == 64
    assert (g.k_stride, g.v_stride) == (96, 72)
    assert g.smem_bytes == 2 * 64 * (96 + 72) * 2 == 43008
    assert g.grid == (72, 16)


def test_launch_geometry_at_the_encoder_shape():
    """hubert-xlarge's attention (8 x 1024 frames, 16 heads of 80,
    float32): ``flash_fwd_mma`` with q in shared memory, 32-key tiles, dh
    padded to 80 and dv to 96."""
    g = fak.launch_geometry(8, 1024, 16, 80, 80, torch.float32)
    assert not g.wgmma and not g.q_in_registers and g.block_k == 32
    assert (g.dh_pad, g.dv_pad, g.dv_class) == (80, 96, 128)
    assert (g.k_stride, g.v_stride) == (80, 100)
    assert g.smem_bytes == (2 * 32 * (80 + 100) + 64 * 80) * 4 == 66560
    assert g.grid == (128, 16)


def test_launch_geometry_largest_fits_one_block_per_sm():
    g = fak.launch_geometry(1, 64, 1, 256, 256, torch.float32)
    assert not g.wgmma and not g.q_in_registers and g.dv_class == 256
    assert g.smem_bytes == (2 * 32 * (272 + 260) + 64 * 272) * 4 == 205824
