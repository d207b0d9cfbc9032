"""K6 on the CPU: the port's plain flash attention against the JAX package.

The same numpy inputs go through the JAX Pallas kernel
(``flash_attention_fwd(..., interpret=True)``, at the block sizes of
``tests/test_flash_kernel.py``), the JAX dense oracle
(``flash_attention_ref``) and the port's wrapper on CPU tensors (which
runs its plain version, ``ref.py``). Tolerance: the JAX kernel test's own
bounds, ``rtol = atol = 3e-5`` in float32 and ``2e-2`` in bfloat16: the
dense and the online softmax sum in other orders. The model's plain
chunked scan is held to the JAX ``_flash_fwd_scan`` the same way.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import kernel as fak
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.models import attention as tattn

F32_TOL = 3e-5
BF16_TOL = 2e-2

SWEEP = [   # (B, S, H, KV, dh, dv), (block_q, block_k), causal
    ((2, 64, 4, 2, 16, 16), (16, 32), True),
    ((1, 128, 6, 3, 32, 16), (64, 32), False),
    ((2, 256, 8, 8, 64, 64), (128, 128), True),
    ((1, 64, 4, 1, 16, 8), (64, 64), True),     # MQA
    ((1, 512, 2, 2, 32, 32), (256, 512), True),
]


def _qkv(dims, seed=0, dtype=np.float32):
    B, S, H, KV, dh, dv = dims
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, dh)).astype(dtype),
            rng.normal(size=(B, S, KV, dh)).astype(dtype),
            rng.normal(size=(B, S, KV, dv)).astype(dtype))


@pytest.mark.parametrize("dims,blocks,causal", SWEEP)
def test_plain_k6_matches_pallas_and_ref(dims, blocks, causal):
    q, k, v = _qkv(dims)
    want_kernel = np.asarray(flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=blocks[0], block_k=blocks[1], interpret=True))
    want_ref = np.asarray(flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = fak.flash_attention_fwd(torch.tensor(q), torch.tensor(k),
                                  torch.tensor(v), causal=causal)
    assert got.dtype == torch.float32
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL)


def test_plain_k6_bf16_matches_pallas():
    rng = np.random.default_rng(1)
    arrs = [rng.normal(size=s) for s in ((2, 64, 4, 16), (2, 64, 2, 16),
                                         (2, 64, 2, 16))]
    jx = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    want = flash_attention_fwd(*jx, causal=True, block_q=32, block_k=32,
                               interpret=True)
    # the same bfloat16 values on both sides
    tx = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
          for a in jx]
    got = fak.flash_attention_fwd(*tx, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("scale", [None, 0.3])
def test_op_is_the_wrapper_on_cpu(scale):
    q, k, v = (torch.tensor(a) for a in _qkv((2, 48, 6, 2, 16, 24), seed=2))
    got = flash_attention_op(q.transpose(1, 2).contiguous().transpose(1, 2),
                             k, v, causal=True, scale=scale)
    want = fak.flash_attention_fwd(q, k, v, causal=True, scale=scale)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["dtype", "heads", "shape", "dim"])
def test_wrapper_rejects_bad_inputs(bad):
    q, k, v = (torch.tensor(a) for a in _qkv((1, 8, 4, 2, 16, 16)))
    if bad == "dtype":
        k = k.double()
    elif bad == "heads":
        q = q[:, :, :3]
    elif bad == "shape":
        v = v[:, :4]
    else:
        q, k = q.repeat(1, 1, 1, 20), k.repeat(1, 1, 1, 20)
    with pytest.raises(ValueError):
        fak.flash_attention_fwd(q, k, v)


def test_cpu_wrapper_does_not_count():
    q, k, v = (torch.tensor(a) for a in _qkv((1, 8, 2, 1, 8, 8)))
    before = fak.flash_attention_fwd.launches
    fak.flash_attention_fwd(q, k, v)
    assert fak.flash_attention_fwd.launches == before


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [8, 16, 64])
@pytest.mark.parametrize("dims", [(2, 64, 6, 2, 16, 16), (1, 32, 4, 4, 8, 4)])
def test_plain_scan_matches_jax_scan(causal, chunk, dims):
    q, k, v = _qkv(dims, seed=3)
    scale = dims[4] ** -0.5
    chunk = min(chunk, dims[1])
    want_out, want_lse = jattn._flash_fwd_scan(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale, chunk)
    got_out, got_lse = tattn._flash_fwd_scan(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), causal, scale,
        chunk)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=F32_TOL, atol=F32_TOL)
    got = tattn._flash_attend(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=causal, scale=scale,
                              chunk=chunk)
    want = jattn._flash_attend(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, scale=scale,
                               chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_plain_scan_bf16_matches_jax_scan():
    rng = np.random.default_rng(4)
    shapes = ((2, 128, 4, 32), (2, 128, 2, 32), (2, 128, 2, 32))
    jx = [jnp.asarray(rng.normal(size=s), jnp.bfloat16) * 4 for s in shapes]
    jx[2] = jx[2] / 4
    tx = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
          for a in jx]
    want = jattn._flash_attend(*jx, causal=True, scale=32 ** -0.5, chunk=32)
    got = tattn._flash_attend(*tx, causal=True, scale=32 ** -0.5, chunk=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_chunk_must_divide_keys_in_both():
    q, k, v = _qkv((1, 48, 2, 2, 8, 8))
    with pytest.raises(AssertionError):
        jattn._flash_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, scale=1.0, chunk=32)
    with pytest.raises(ValueError, match="multiple"):
        tattn._flash_attend(torch.tensor(q), torch.tensor(k),
                            torch.tensor(v), causal=True, scale=1.0,
                            chunk=32)
