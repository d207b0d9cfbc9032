"""The port's AdamW (``repro_torch.optim.adamw``) against the JAX
package's ``repro.optim.adamw``.

``lr_schedule`` runs the same float32 operations as the reference and is
held to it bit for bit; so are ``_quantize`` / ``_dequantize`` (a
float32 max, one division, round half to even). ``apply_updates`` is fed
the same parameters and JAX's own gradients on both sides, three steps in
a row; ``grad_norm`` sums the squares in another order, so it, the
parameters and the moments are held to ``TOL`` x the largest |value| of
JAX's. With quantized moments a value whose float32 differs in its last
bit may round to the neighbouring int8 level, so the dequantized moments
are held to one level, ``scale`` (the block's largest |value| / 127), of
JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch.optim import adamw as tadamw

TOL = 1e-6
SHAPES = {"a": (40, 300), "b": (7,), "c": (3, 5, 260), "d": (512,),
          "e": (16, 16)}


@pytest.mark.parametrize("kw", [dict(), dict(warmup_steps=20,
                                             decay_steps=50),
                                dict(warmup_steps=5, decay_steps=3,
                                     lr_peak=1e-3, lr_min=0.0)])
def test_lr_schedule_bit_equal(kw):
    jc, tc = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    for step in [0, 1, 2, 4, 5, 19, 20, 21, 33, 49, 50, 51, 99, 100, 101,
                 5000, 9999, 10_000, 20_000]:
        want = np.asarray(jadamw.lr_schedule(jc, jnp.int32(step)))
        got = tadamw.lr_schedule(tc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes(), step


@pytest.mark.parametrize("shape", [(300,), (2, 256), (3, 5, 260), (1, 7),
                                   (4, 513)])
def test_quantize_bit_equal(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 10.0 ** rng.integers(
        -6, 2, shape)).astype(np.float32)
    x.reshape(-1)[:3] = 0.0
    jq = jadamw._quantize(jnp.asarray(x))
    tq = tadamw._quantize(torch.tensor(x))
    assert tq.q.dtype == torch.int8 and tq.scale.dtype == torch.float32
    assert np.array_equal(tq.q.numpy(), np.asarray(jq.q))
    assert tq.scale.numpy().tobytes() == np.asarray(jq.scale).tobytes()
    back_j = np.asarray(jadamw._dequantize(jq, shape))
    back_t = tadamw._dequantize(tq, shape).numpy()
    assert back_t.shape == shape and back_t.tobytes() == back_j.tobytes()


def test_quantize_zeros_stay_zero():
    q = tadamw._quantize(torch.zeros(3, 300))
    assert torch.equal(tadamw._dequantize(q, (3, 300)), torch.zeros(3, 300))


def _moment(x, shape):
    if isinstance(x, (tadamw.Quantized, jadamw.Quantized)):
        deq = (tadamw._dequantize(x, shape).numpy()
               if isinstance(x, tadamw.Quantized)
               else np.asarray(jadamw._dequantize(x, shape)))
        return deq, np.asarray(x.scale if isinstance(x, jadamw.Quantized)
                               else x.scale.numpy())
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x), None


@pytest.mark.parametrize("quantize", [False, True])
def test_apply_updates_fed_jax_grads(quantize):
    rng = np.random.default_rng(0)
    params = {k: (rng.standard_normal(s) * 0.05).astype(np.float32)
              for k, s in sorted(SHAPES.items())}
    cfg_kw = dict(warmup_steps=2, decay_steps=6, quantize_moments=quantize,
                  grad_clip=1.0)
    jc, tc = jadamw.AdamWConfig(**cfg_kw), tadamw.AdamWConfig(**cfg_kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    js = jadamw.init_opt_state(jc, jp)
    ts = tadamw.init_opt_state(tc, tp)
    quantized = sorted(k for k, m in ts.m.items()
                       if isinstance(m, tadamw.Quantized))
    assert quantized == sorted(k for k, m in js.m.items()
                               if isinstance(m, jadamw.Quantized))
    assert quantized == (["a", "c", "d", "e"] if quantize else [])
    upd = jax.jit(lambda p, g, s: jadamw.apply_updates(jc, p, g, s))
    for step in range(3):
        grads = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
                 for k, s in sorted(SHAPES.items())}
        jp, js, jm = upd(jp, {k: jnp.asarray(g) for k, g in grads.items()},
                         js)
        same, ts, tm = tadamw.apply_updates(
            tc, tp, {k: torch.tensor(g) for k, g in grads.items()}, ts)
        assert same is tp and int(ts.step) == int(js.step) == step + 1
        assert tm["lr"].numpy().tobytes() == np.asarray(jm["lr"]).tobytes()
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            TOL * float(jm["grad_norm"])
        for k in SHAPES:
            want = np.asarray(jp[k])
            np.testing.assert_allclose(tp[k].detach().numpy(), want, rtol=0,
                                       atol=TOL * np.abs(want).max(),
                                       err_msg=f"step {step} param {k}")
            for name in ("m", "v"):
                got, _ = _moment(getattr(ts, name)[k], SHAPES[k])
                want, scale = _moment(getattr(js, name)[k], SHAPES[k])
                if scale is None:
                    atol = TOL * np.abs(want).max()
                else:      # one int8 level of the block, past float32's
                    atol = np.broadcast_to(
                        scale, scale.shape[:-1] + (256,)).reshape(
                        *scale.shape[:-2], -1)[..., :SHAPES[k][-1]]
                    atol = atol.reshape(SHAPES[k]) * 1.0001
                assert np.all(np.abs(got - want) <= atol), \
                    f"step {step} {name} {k}"


def test_global_norm_and_clip():
    """The update is clipped to ``grad_clip`` of the global norm."""
    tc = tadamw.AdamWConfig(warmup_steps=1, decay_steps=2, weight_decay=0.0)
    p = {"w": torch.zeros(4, requires_grad=True)}
    g = {"w": torch.tensor([3.0, 4.0, 0.0, 0.0])}
    assert float(tadamw.global_norm(g.values())) == 5.0
    _, s, m = tadamw.apply_updates(tc, p, g, tadamw.init_opt_state(tc, p))
    assert float(m["grad_norm"]) == 5.0
    # m = 0.1 * g / 5 after clipping; Adam's first step moves by ~lr * sign
    torch.testing.assert_close(s.m["w"], 0.1 * g["w"] / 5)
    assert torch.all(p["w"][:2] < 0) and torch.all(p["w"][2:] == 0)
