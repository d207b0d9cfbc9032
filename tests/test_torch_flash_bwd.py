"""The attention's autograd Function (``_FlashCore``, the counterpart of
the JAX package's ``_flash_core`` custom VJP) against ``jax.vjp`` of
``repro.models.attention._flash_attend``.

The same numpy q, k, v and output cotangent go into both; on the CPU the
port's forward is the plain scan and its backward ``_flash_core_bwd``,
the same backward the card runs after K6. Both sides compute in float32
in the same operation order and differ only in summation order inside
the products, so ``dq``, ``dk`` and ``dv`` are held to ``GRAD_TOL`` x
the largest |value| of JAX's, and the forward's ``out`` and ``lse`` to
``FWD_TOL`` x theirs. bfloat16 rounds the products' operands at the same
places on both sides; it is held to ``BF16_TOL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import attention as tattn

GRAD_TOL = 1e-5
FWD_TOL = 1e-6
BF16_TOL = 2e-2

# (B, Sq, Sk, H, KV, dh, dv), causal, chunk: GQA and MQA, dh != dv (qk 48
# / v 32), chunk < Sk (several key chunks), chunk == Sk
CASES = [
    ((2, 64, 64, 4, 2, 16, 16), True, 16),
    ((2, 64, 64, 4, 2, 16, 16), False, 16),
    ((1, 48, 48, 6, 1, 48, 32), True, 16),
    ((1, 48, 48, 6, 1, 48, 32), False, 48),
    ((2, 32, 32, 4, 4, 8, 8), True, 32),
    ((1, 64, 64, 8, 2, 48, 32), True, 8),
]


def _inputs(dims, seed=0):
    B, Sq, Sk, H, KV, dh, dv = dims
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(B, Sq, H, dh), f(B, Sk, KV, dh), f(B, Sk, KV, dv), \
        f(B, Sq, H, dv)


def _jax_vjp(q, k, v, dout, causal, scale, chunk, dtype=jnp.float32):
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    out, vjp = jax.vjp(lambda a, b, c: jattn._flash_attend(
        a, b, c, causal=causal, scale=scale, chunk=chunk), *args)
    return out, vjp(jnp.asarray(dout, dtype))


def _torch_grads(q, k, v, dout, causal, scale, chunk, dtype=torch.float32):
    ts = [torch.tensor(x, dtype=dtype, requires_grad=True)
          for x in (q, k, v)]
    out = tattn._flash_attend(*ts, causal=causal, scale=scale, chunk=chunk)
    out.backward(torch.tensor(dout, dtype=dtype))
    return out, [t.grad for t in ts]


def _close(got, want, tol, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("dims,causal,chunk", CASES)
def test_grads_match_jax_vjp(dims, causal, chunk):
    q, k, v, dout = _inputs(dims)
    scale = dims[5] ** -0.5
    out_j, grads_j = _jax_vjp(q, k, v, dout, causal, scale, chunk)
    out_t, grads_t = _torch_grads(q, k, v, dout, causal, scale, chunk)
    _close(out_t, out_j, FWD_TOL, "out")
    for name, a, b in zip("qkv", grads_t, grads_j):
        assert a.dtype == torch.float32
        _close(a, b, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("dims,causal,chunk", CASES[:3])
def test_bf16_grads_match_jax_vjp(dims, causal, chunk):
    q, k, v, dout = _inputs(dims, seed=1)
    scale = dims[5] ** -0.5
    _, grads_j = _jax_vjp(q, k, v, dout, causal, scale, chunk, jnp.bfloat16)
    _, grads_t = _torch_grads(q, k, v, dout, causal, scale, chunk,
                              torch.bfloat16)
    for name, a, b in zip("qkv", grads_t, grads_j):
        assert a.dtype == torch.bfloat16
        _close(a, np.asarray(b, np.float32), BF16_TOL, f"d{name}")


@pytest.mark.parametrize("dims,causal,chunk", CASES[:4])
def test_flash_core_lse_matches_jax_scan(dims, causal, chunk):
    """The Function's second output is the JAX scan's lse."""
    q, k, v, _ = _inputs(dims, seed=2)
    scale = dims[5] ** -0.5
    _, lse_j = jattn._flash_fwd_scan(*(jnp.asarray(x) for x in (q, k, v)),
                                     causal, scale, chunk)
    out, lse = tattn.flash_core(*(torch.tensor(x) for x in (q, k, v)),
                                causal=causal, scale=scale, chunk=chunk,
                                return_lse=True)
    _close(lse, lse_j, FWD_TOL, "lse")
    assert not lse.requires_grad


def test_plain_version_lse_is_the_scan_lse():
    """``flash_attention_ref(return_lse=True)`` (the version the card
    holds K6's lse to) gives the scan's lse and the wrapper passes it on
    for CPU tensors."""
    dims = (2, 40, 72, 4, 2, 24, 16)
    q, k, v, _ = (torch.tensor(x) for x in _inputs(dims, seed=3))
    out, lse = flash_attention_ref(q, k, v, causal=True, return_lse=True)
    out2, lse2 = flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert lse.shape == (2, 4, 40) and lse.dtype == torch.float32
    _, lse_scan = tattn._flash_fwd_scan(q, k, v, True, 24 ** -0.5, 72)
    _close(lse, lse_scan, FWD_TOL, "lse")


def test_shorter_last_chunk_equals_whole():
    """The Function takes any key length: a shorter last key chunk gives
    the grads of one chunk over all keys."""
    dims = (1, 40, 40, 4, 2, 16, 16)
    q, k, v, dout = _inputs(dims, seed=4)
    f = tattn._flash_core_bwd
    ts = [torch.tensor(x) for x in (q, k, v)]
    out32, lse = tattn._flash_fwd_scan(*ts, True, 0.25, 40)
    res = (*ts, out32, lse)
    whole = f(True, 0.25, 40, res, torch.tensor(dout))
    parts = f(True, 0.25, 16, res, torch.tensor(dout))
    for a, b in zip(whole, parts):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=GRAD_TOL * b.abs().max().item())


def test_no_grad_path_unchanged():
    """Without autograd the prefill keeps the plain scan (on the CPU) and
    its output is the Function's."""
    dims = (1, 32, 32, 4, 2, 16, 16)
    q, k, v, _ = (torch.tensor(x) for x in _inputs(dims, seed=5))
    with torch.inference_mode():
        plain = tattn._flash_attend(q, k, v, causal=True, scale=0.25,
                                    chunk=16)
    qg = q.clone().requires_grad_()
    tracked = tattn._flash_attend(qg, k, v, causal=True, scale=0.25,
                                  chunk=16)
    assert tracked.requires_grad and not plain.requires_grad
    assert torch.equal(plain, tracked.detach())
