"""The port's Mamba2 (SSD) block against the JAX package's, on the CPU.

The same numpy inputs go through ``repro.models.mamba`` and
``repro_torch.models.mamba``: the depthwise causal conv (prefill below,
at and above ``d_conv - 1`` tokens, and a decode step), the chunked SSD
scan (1, 2 and 4 chunks, from a zero and from a given state) and the
whole block (a prefill into a cache, then 3 decode steps). The block's
``A_log``, ``dt_bias``, ``D``, ``conv_b`` and ``norm_g`` are drawn at
random in both packages, so that a swapped or dropped leaf shows. Both
run float32 and differ only in summation order. Tolerance: ``TOL`` x
the largest |value| of each JAX output or cache leaf (absolute).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.models import mamba as jmamba
from repro.models.layers import Sharder
from repro_torch.configs.base import get_config, smoke_variant
from repro_torch.interop import model_from_params, numpy_params
from repro_torch.models import mamba as tmamba
from repro_torch.models.mamba import SSMCache

TOL = 1e-5
ARCH = "mamba2-370m"


def _close(got, want, what):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max(), err_msg=what)


def _t(x):
    return torch.tensor(np.array(x))


# ---------------------------------------------------------------------------
# The causal conv
# ---------------------------------------------------------------------------

def _conv_oracle(u, w, b):
    """Causal depthwise conv with K - 1 zeros in front, in float64, and
    SiLU: ``out[t] = silu(sum_i up[t + i] w[i] + b)``."""
    K, (B, S, C) = w.shape[0], u.shape
    up = np.concatenate([np.zeros((B, K - 1, C)), u], 1)
    out = sum(up[:, i:i + S] * w[i] for i in range(K)) + b
    return out / (1 + np.exp(-out)), up[:, -(K - 1):]


@pytest.mark.parametrize("S", [1, 2, 3, 4, 9])
def test_causal_conv_prefill_matches_jax(S):
    """K = 4: S below, at and above K - 1. The returned conv cache is the
    last K - 1 pre-conv inputs, the zero pad among them where S < 3. Held
    to JAX where S >= K - 1 and to a float64 oracle at every S: below K -
    1 the reference pads only S zeros (``zeros_like(u[:, :K - 1])``), so
    its output is empty at S = 1 and mixes broadcast terms at S = 2
    (ROADMAP §3), and the port pads K - 1."""
    rng = np.random.default_rng(S)
    B, C, K = 2, 12, 4
    u = rng.normal(size=(B, S, C)).astype(np.float32)
    w = rng.normal(size=(K, C)).astype(np.float32)
    b = rng.normal(size=C).astype(np.float32)
    got, got_c = tmamba._causal_conv(_t(u), _t(w), _t(b))
    want, want_c = _conv_oracle(u, w, b)
    _close(got, want, "out against the oracle")
    _close(got_c, want_c, "conv cache against the oracle")
    assert got_c.shape == (B, K - 1, C)
    assert np.all(got_c.numpy()[:, :max(K - 1 - S, 0)] == 0)
    jout, jc = jmamba._causal_conv(jnp.asarray(u), jnp.asarray(w),
                                   jnp.asarray(b))
    if S >= K - 1:
        _close(got, jout, "out")
        _close(got_c, jc, "conv cache")
    else:
        assert S == 1 and jout.shape[1] == 0 or not np.allclose(
            np.asarray(jout), want, atol=1e-3)


def test_causal_conv_decode_matches_jax():
    rng = np.random.default_rng(7)
    B, C, K = 3, 12, 4
    u = rng.normal(size=(B, 1, C)).astype(np.float32)
    cache = rng.normal(size=(B, K - 1, C)).astype(np.float32)
    w = rng.normal(size=(K, C)).astype(np.float32)
    b = rng.normal(size=C).astype(np.float32)
    want, want_c = jmamba._causal_conv(jnp.asarray(u), jnp.asarray(w),
                                       jnp.asarray(b), jnp.asarray(cache))
    got, got_c = tmamba._causal_conv(_t(u), _t(w), _t(b), _t(cache))
    _close(got, want, "out")
    _close(got_c, want_c, "conv cache")
    assert np.array_equal(got_c.numpy(), np.concatenate([cache, u], 1)[:, 1:])


def test_causal_conv_decode_continues_the_prefill():
    """On the port alone: a prefill of 6 tokens and a decode step of the
    7th give a prefill of all 7, output and cache."""
    rng = np.random.default_rng(8)
    u = _t(rng.normal(size=(2, 7, 10)).astype(np.float32))
    w = _t(rng.normal(size=(4, 10)).astype(np.float32))
    b = _t(rng.normal(size=10).astype(np.float32))
    full, full_c = tmamba._causal_conv(u, w, b)
    _, pre_c = tmamba._causal_conv(u[:, :6], w, b)
    step, step_c = tmamba._causal_conv(u[:, 6:], w, b, pre_c)
    _close(step, full[:, 6:], "decode out")
    _close(step_c, full_c, "conv cache")


# ---------------------------------------------------------------------------
# The chunked SSD scan
# ---------------------------------------------------------------------------

def _ssd_inputs(rng, B=2, S=64, H=3, P=8, N=5):
    xh = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    A = np.exp(rng.normal(size=H) * 0.5).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    h0 = rng.normal(size=(B, H, P, N)).astype(np.float32)
    return xh, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("n", [1, 5, 16, 17, 64, 100, 256, 1024])
def test_cumsum_rounds_as_jax(n):
    """``_cumsum`` gives ``jnp.cumsum``'s float32 bits on the CPU (XLA's
    base-16 tree order) along the SSD's axis 2, where ``torch.cumsum``
    rounds otherwise; on positive terms of about 2, as the SSD's
    ``dt * A``."""
    rng = np.random.default_rng(n)
    x = (np.log1p(np.exp(rng.normal(size=(2, 3, n, 4)))) * np.e).astype(
        np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=2))
    got = tmamba._cumsum(_t(x), dim=2).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got, want)
    if n >= 256:
        assert not np.array_equal(torch.cumsum(_t(x), 2).numpy(), want)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("nc", [1, 2, 4])
def test_ssd_chunked_matches_jax(nc, with_state):
    """64 steps in nc chunks, from zero or from a random state: outputs
    and the final state (a pre-chunk state off by one chunk shows only
    where nc > 1)."""
    xh, dt, A, Bm, Cm, h0 = _ssd_inputs(np.random.default_rng(nc))
    chunk = 64 // nc
    init = h0 if with_state else None
    want_y, want_h = jmamba._ssd_chunked(
        *(jnp.asarray(a) for a in (xh, dt, A, Bm, Cm)), chunk,
        None if init is None else jnp.asarray(init))
    got_y, got_h = tmamba._ssd_chunked(
        *(_t(a) for a in (xh, dt, A, Bm, Cm)), chunk,
        None if init is None else _t(init))
    _close(got_y, want_y, "y")
    _close(got_h, want_h, "final state")
    assert got_h.dtype == torch.float32


def test_ssd_chunked_equals_the_recurrence():
    """On the port alone: 4 chunks give the step-by-step recurrence
    ``h_t = exp(-dt_t A) h_{t-1} + dt_t B_t x_t``, ``y_t = C_t . h_t``."""
    xh, dt, A, Bm, Cm, h0 = _ssd_inputs(np.random.default_rng(9), S=32)
    y, hT = tmamba._ssd_chunked(*(_t(a) for a in (xh, dt, A, Bm, Cm)), 8,
                                _t(h0))
    h = h0.astype(np.float64)
    ys = []
    for t in range(32):
        a = np.exp(-dt[:, t] * A[None])                       # (B, H)
        h = h * a[:, :, None, None] + np.einsum(
            "bh,bn,bhp->bhpn", dt[:, t], Bm[:, t], xh[:, t])
        ys.append(np.einsum("bn,bhpn->bhp", Cm[:, t], h))
    _close(y, np.stack(ys, 1), "y")
    _close(hT, h, "final state")


def test_ssd_chunked_raises_off_the_chunk():
    xh, dt, A, Bm, Cm, _ = _ssd_inputs(np.random.default_rng(3), S=48)
    with pytest.raises(ValueError, match="multiple of the SSD chunk 32"):
        tmamba._ssd_chunked(*(_t(a) for a in (xh, dt, A, Bm, Cm)), 32)
    with pytest.raises(AssertionError):
        jmamba._ssd_chunked(*(jnp.asarray(a) for a in (xh, dt, A, Bm, Cm)),
                            32)


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------

def _block(seed=2):
    """mamba2's smoke variant (d_model 128, d_inner 256, 8 heads of 32,
    d_state 16, chunk 64), layer 0's mixer from ``numpy_params`` with
    ``A_log``, ``dt_bias``, ``D``, ``conv_b`` and ``norm_g`` drawn at
    random: the JAX leaves as ``(array,)`` pairs and the port's
    ``Mamba`` holding the same tree."""
    cfg = smoke_variant(get_config(ARCH))
    jcfg = jax_smoke_variant(jax_get_config(ARCH))
    params = numpy_params(cfg, seed=seed)
    tree = params["body"]["sub0"]["mixer"]
    rng = np.random.default_rng(seed + 10)
    for k, loc, std in (("A_log", 0.0, 0.5), ("dt_bias", 0.0, 0.5),
                        ("D", 1.0, 0.3), ("conv_b", 0.0, 0.1),
                        ("norm_g", 1.0, 0.2)):
        tree[k] = (loc + std * rng.standard_normal(tree[k].shape)).astype(
            np.float32)
    model = model_from_params(cfg, params, device="cpu")
    pairs = {k: (jnp.asarray(x[0]),) for k, x in tree.items()}
    return cfg, jcfg, pairs, model.layers[0].mixer


def _jax_cache(c):
    return jmamba.SSMCache(*(jnp.asarray(x) for x in c))


def _cache_close(got: SSMCache, want, what):
    _close(got.state, want.state, f"{what} state")
    _close(got.conv, want.conv, f"{what} conv")
    assert got.state.dtype == torch.float32
    assert int(got.length) == int(want.length), what
    assert got.length.dtype == torch.int32


@pytest.mark.parametrize("S", [32, 128])
def test_mamba_apply_prefill_then_decode_matches_jax(S):
    """A prefill of S tokens (1 and 2 chunks) into a cache, then 3 decode
    steps feeding each step's cache to the next: every output and every
    ``SSMCache`` leaf as in JAX."""
    cfg, jcfg, pairs, mixer = _block()
    rng = np.random.default_rng(S)
    B = 2
    x = rng.normal(size=(B, S + 3, cfg.d_model)).astype(np.float32)
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    empty = (np.zeros((B, s.n_heads(cfg.d_model), s.head_dim, s.d_state),
                      np.float32),
             np.zeros((B, s.d_conv - 1, di + 2 * s.d_state), np.float32),
             np.int32(0))
    want, jc = jmamba.mamba_apply(pairs, jnp.asarray(x[:, :S]), jcfg,
                                  Sharder(), cache=_jax_cache(empty))
    with torch.no_grad():
        got, tc = tmamba.mamba_apply(mixer, _t(x[:, :S]), cfg,
                                     cache=SSMCache(*(_t(a) for a in empty)))
    _close(got, want, "prefill")
    _cache_close(tc, jc, "prefill")
    for t in range(S, S + 3):
        want, jc = jmamba.mamba_apply(pairs, jnp.asarray(x[:, t:t + 1]),
                                      jcfg, Sharder(), cache=jc, decode=True)
        with torch.no_grad():
            got, tc = mixer(_t(x[:, t:t + 1]), cache=tc, decode=True)
        _close(got, want, f"decode {t}")
        _cache_close(tc, jc, f"decode {t}")
    assert int(tc.length) == S + 3


def test_mamba_apply_without_cache_and_off_the_chunk():
    """No cache: the same prefill output and no cache back, as JAX. A
    prompt longer than the chunk and not a multiple of it raises in both
    packages; decode without a cache raises."""
    cfg, jcfg, pairs, mixer = _block()
    x = np.random.default_rng(4).normal(size=(2, 64, cfg.d_model)).astype(
        np.float32)
    want, jc = jmamba.mamba_apply(pairs, jnp.asarray(x), jcfg, Sharder())
    with torch.no_grad():
        got, tc = tmamba.mamba_apply(mixer, _t(x), cfg)
    assert tc is None and jc is None
    _close(got, want, "prefill")
    bad = np.concatenate([x, x[:, :16]], 1)          # 80 = 64 + 16
    with pytest.raises(ValueError, match="multiple of the SSD chunk 64"):
        with torch.no_grad():
            tmamba.mamba_apply(mixer, _t(bad), cfg)
    with pytest.raises(AssertionError):
        jmamba.mamba_apply(pairs, jnp.asarray(bad), jcfg, Sharder())
    with pytest.raises(ValueError, match="one token and a cache"):
        with torch.no_grad():
            tmamba.mamba_apply(mixer, _t(x[:, :1]), cfg, decode=True)


def test_init_mamba_stds_and_constants():
    """The port's own init: ``in_proj`` ``d_model ** -0.5``, ``conv_w``
    ``d_conv ** -0.5`` and ``out_proj`` ``di ** -0.5 / (2 n_layers) **
    0.5`` within 10%; ``A_log``, ``D``, ``norm_g`` ones and ``dt_bias``,
    ``conv_b`` zeros exactly."""
    cfg = get_config(ARCH)
    s, D = cfg.ssm, cfg.d_model
    di = s.d_inner(D)
    p = tmamba.init_mamba(tmamba.Mamba(cfg, device="cpu"),
                          torch.Generator().manual_seed(0))
    for w, std in ((p.in_proj.weight, D ** -0.5),
                   (p.conv_w, s.d_conv ** -0.5),
                   (p.out_proj.weight, di ** -0.5 / (2 * cfg.n_layers) ** 0.5)):
        assert abs(w.std().item() / std - 1) < 0.1
    assert tuple(p.in_proj.weight.shape) == (2 * di + 2 * s.d_state
                                             + s.n_heads(D), D)
    assert tuple(p.conv_w.shape) == (s.d_conv, di + 2 * s.d_state)
    for one in (p.A_log, p.D, p.norm_g):
        assert torch.equal(one, torch.ones_like(one))
    for zero in (p.dt_bias, p.conv_b):
        assert torch.equal(zero, torch.zeros_like(zero))
