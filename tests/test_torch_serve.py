"""The port's LLM serving path against the JAX package, on the CPU.

Weights cross from the JAX layout (``repro_torch.interop.numpy_params``).
``greedy_generate``'s tokens must equal the JAX package's, and each step's
logits must agree through ``chip_smoke.check_serve`` -- the rule the chip
smoke applies at full width -- at ``SERVE_TOL`` x the step's largest
|logit|: float32 on both sides, other summation orders, about 1e-6 of the
largest logit at this size. The JAX side steps with
``torch_smoke_constants.jax_generate``, which must give the JAX
``greedy_generate``'s tokens.
"""
import dataclasses
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_smoke_constants as consts

import chip_smoke
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.models.layers import Sharder
from repro.models.model import init_model as jax_init_model
from repro.serve.engine import greedy_generate as jax_greedy_generate
from repro_torch.configs.base import get_config, smoke_variant
from repro_torch.interop import model_from_params, numpy_params
from repro_torch.kernels.flash_attention import kernel as fak
from repro_torch.models.mlp import moe_capacity
from repro_torch.serve.engine import greedy_generate

ROOT = pathlib.Path(__file__).resolve().parents[1]
SERVE_TOL = 1e-5
RUNNABLE = ["chameleon-34b", "command-r-plus-104b", "deepseek-v2-236b",
            "jamba-v0.1-52b", "mamba2-370m", "minitron-8b",
            "nemotron-4-340b", "phi3.5-moe-42b-a6.6b", "smollm-135m"]


@pytest.mark.parametrize("arch", RUNNABLE)
def test_greedy_generate_matches_jax(arch):
    cfg = smoke_variant(get_config(arch))
    jcfg = jax_smoke_variant(jax_get_config(arch))
    B, S, new = 3, 16, 6
    params = numpy_params(cfg, seed=1)
    prompts = chip_smoke.serve_prompts(cfg.vocab, B, S)
    axes = jax_init_model(jcfg, jax.random.PRNGKey(0))[1]
    jparams = jax.tree.map(jnp.asarray, params)
    want_tokens, want_logits = consts.jax_generate(jcfg, jparams, axes,
                                                   prompts, new)
    jax_tokens = jax_greedy_generate(jcfg, jparams, axes, Sharder(),
                                     jnp.asarray(prompts), new)
    assert np.array_equal(np.asarray(jax_tokens), want_tokens)

    model = model_from_params(cfg, params, device="cpu")
    got_tokens = greedy_generate(model, torch.tensor(prompts), new)
    assert got_tokens.dtype == torch.int32
    assert np.array_equal(got_tokens.numpy(), want_tokens)

    before = fak.flash_attention_fwd.launches
    steps, *_ = chip_smoke.port_serve(model, torch.tensor(prompts), new,
                                      S + new)
    assert fak.flash_attention_fwd.launches == before   # plain on the CPU
    assert np.array_equal(np.stack([t for t, _ in steps], 1), want_tokens)
    report = chip_smoke.check_serve(
        steps, [chip_smoke.top5_records(lg) for lg in want_logits],
        tol=SERVE_TOL)
    assert report["steps_compared"] == [new] * B
    for (_, got), want in zip(steps, want_logits):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=SERVE_TOL * np.abs(want).max())


def test_check_serve_catches_a_wrong_token_and_logit():
    """The smoke's comparison fails on a flipped decisive token and on a
    logit off by more than its tolerance, and stops a request at a
    near-tie."""
    rng = np.random.default_rng(0)
    logits = [rng.normal(size=(2, 50)).astype(np.float32) for _ in range(3)]
    want = [chip_smoke.top5_records(lg) for lg in logits]
    steps = [(np.argmax(lg, -1), lg.copy()) for lg in logits]
    assert chip_smoke.check_serve(steps, want)["steps_compared"] == [3, 3]
    bad = [(t.copy(), lg.copy()) for t, lg in steps]
    bad[1][0][0] = want[1]["ids"][0][1]
    with pytest.raises(AssertionError, match="token"):
        chip_smoke.check_serve(bad, want)
    bad = [(t.copy(), lg.copy()) for t, lg in steps]
    bad[2][1][1, want[2]["ids"][1][3]] += 0.01 * want[2]["absmax"][1]
    with pytest.raises(AssertionError, match="top-5 logits"):
        chip_smoke.check_serve(bad, want)
    tie = [lg.copy() for lg in logits]
    i0, i1 = want[0]["ids"][1][:2]
    tie[0][1, i1] = tie[0][1, i0]
    tie[1][1] = -tie[1][1]          # a continuation that differs after it
    report = chip_smoke.check_serve(
        [(np.argmax(lg, -1), lg) for lg in tie[:1]] + steps[1:],
        [chip_smoke.top5_records(lg) for lg in tie])
    assert report["steps_compared"] == [3, 1]
    assert report["near_ties"] == [(1, 0)]


@pytest.mark.parametrize("fault", ["wrong kv head", "keys past 64 dropped",
                                   "no causal mask"])
def test_check_serve_catches_wrong_attention(fault, monkeypatch):
    """The serve tolerance has teeth: attention that reads the wrong kv
    head, loses a key tile or forgets the causal mask moves the logits by
    more than 100x ``chip_smoke.LOGIT_TOL`` of the largest |logit|, and
    ``check_serve`` fails."""
    from repro_torch.models import attention
    cfg = smoke_variant(get_config("smollm-135m"))
    model = model_from_params(cfg, numpy_params(cfg, seed=0), device="cpu")
    prompts = torch.tensor(chip_smoke.serve_prompts(cfg.vocab, 2, 128))
    steps, *_ = chip_smoke.port_serve(model, prompts, 3, 131)
    want = [chip_smoke.top5_records(lg) for _, lg in steps]
    right = attention._flash_attend
    wrong = {
        "wrong kv head": lambda q, k, v, **kw: right(
            q, k.roll(1, 2), v.roll(1, 2), **kw),
        "keys past 64 dropped": lambda q, k, v, **kw: right(
            q, k[:, :64], v[:, :64], **kw),
        "no causal mask": lambda q, k, v, causal, **kw: right(
            q, k, v, causal=False, **kw),
    }[fault]
    monkeypatch.setattr(attention, "_flash_attend", wrong)
    bad, *_ = chip_smoke.port_serve(model, prompts, 3, 131)
    err = max(np.abs(b[1] - g[1]).max() / np.abs(g[1]).max()
              for b, g in zip(bad, steps))
    assert err > 100 * chip_smoke.LOGIT_TOL
    with pytest.raises(AssertionError):
        chip_smoke.check_serve(bad, want)


@pytest.mark.parametrize("fault", ["scale of cfg.dh", "rope half of k dropped"])
def test_check_layer0_and_serve_catch_wrong_mla(fault, monkeypatch):
    """The MLA phase's checks have teeth: scaling the prefill scores by
    ``cfg.dh ** -0.5`` (40 at full width) in place of the qk width's
    (``(nope + rope) ** -0.5``), or dropping the rope half of every key,
    moves the hidden state after layer 0 past ``check_layer0``'s
    tolerance and the logits past ``check_serve``'s. deepseek's smoke
    variant at 2 layers, with ``head_dim`` 40 so that ``cfg.dh`` differs
    from the qk width (32) as it does at full width."""
    from repro_torch.models import attention
    cfg = dataclasses.replace(smoke_variant(get_config("deepseek-v2-236b")),
                              n_layers=2, head_dim=40)
    nope = cfg.mla.qk_nope_dim
    assert cfg.dh != nope + cfg.mla.qk_rope_dim
    model = model_from_params(cfg, numpy_params(cfg, seed=0), device="cpu")
    prompts = torch.tensor(chip_smoke.serve_prompts(cfg.vocab, 2, 128))
    rows = chip_smoke.layer0_rows(model, prompts, 131)
    steps, *_ = chip_smoke.port_serve(model, prompts, 3, 131)
    want_rows = {f"layer0_{k}": v for k, v in rows.items()}
    want = [chip_smoke.top5_records(lg) for _, lg in steps]
    chip_smoke.check_layer0(rows, want_rows)
    chip_smoke.check_serve(steps, want)
    right = attention._flash_attend
    wrong = {
        "scale of cfg.dh": lambda q, k, v, scale, **kw: right(
            q, k, v, scale=cfg.dh ** -0.5, **kw),
        "rope half of k dropped": lambda q, k, v, **kw: right(
            q, torch.cat([k[..., :nope], torch.zeros_like(k[..., nope:])],
                         -1), v, **kw),
    }[fault]
    monkeypatch.setattr(attention, "_flash_attend", wrong)
    bad_rows = chip_smoke.layer0_rows(model, prompts, 131)
    bad, *_ = chip_smoke.port_serve(model, prompts, 3, 131)
    with pytest.raises(AssertionError, match="layer 0 hidden"):
        chip_smoke.check_layer0(bad_rows, want_rows)
    with pytest.raises(AssertionError):
        chip_smoke.check_serve(bad, want)


def test_serve_constants_fit_the_smoke():
    """The committed constants were made for the smoke's serve setup."""
    want = json.loads(chip_smoke.SERVE_CONSTANTS.read_text())
    assert (want["arch"], want["B"], want["S"], want["max_new"],
            want["seed"]) == (chip_smoke.SERVE_ARCH, chip_smoke.SERVE_B,
                              chip_smoke.SERVE_S, chip_smoke.SERVE_NEW,
                              chip_smoke.SEED)
    assert len(want["steps"]) == chip_smoke.SERVE_NEW
    for rec in want["steps"]:
        assert np.asarray(rec["ids"]).shape == (chip_smoke.SERVE_B, 5)


def test_moe_constants_fit_the_smoke():
    """The committed MoE constants were made for the smoke's MoE setup:
    every step and request of the JSON, and every MoE layer of the prefill
    and of each decode step in the npz, with the prefill's capacity."""
    want = json.loads(chip_smoke.MOE_CONSTANTS.read_text())
    assert {k: want[k] for k in chip_smoke.moe_setup()} == \
        chip_smoke.moe_setup()
    assert len(want["steps"]) == chip_smoke.SERVE_NEW
    for rec in want["steps"]:
        assert np.asarray(rec["ids"]).shape == (chip_smoke.SERVE_B, 5)
    cfg = chip_smoke.moe_config(get_config(chip_smoke.MOE_ARCH))
    E, L, B = cfg.moe.n_experts, cfg.n_layers, chip_smoke.SERVE_B
    T = B * chip_smoke.SERVE_S
    z = np.load(chip_smoke.MOE_ROUTING)
    assert int(z["capacity"]) == moe_capacity(cfg, T, decode=False)
    assert z["prefill_scores"].shape == (L, 1, T, E)
    assert z["prefill_auction_dispatch"].shape == (L, 1, T, E)
    assert z["skewed_scores"].shape == (T, E)
    assert z["decode_dispatch"].shape == (chip_smoke.SERVE_NEW - 1, L, 1, B,
                                          E)
    assert z["decode_unstable"].shape == (chip_smoke.SERVE_NEW - 1, L, B)
    assert z["skewed_auction_prices"].max() > 0   # the price rounds engage


def test_deepseek_constants_fit_the_smoke():
    """The committed deepseek constants were made for the MLA phase's setup
    (full width, DS_LAYERS layers): every step and request of the JSON;
    in the npz the one MoE layer (the last) of the prefill and of each
    decode step at the prefill's capacity, a mark per prefill token, the
    skewed set at 160 experts with a raised price, and layer 0's hidden
    state and cache rows at the sampled positions."""
    want = json.loads(chip_smoke.MLA_CONSTANTS.read_text())
    assert {k: want[k] for k in chip_smoke.mla_setup()} == \
        chip_smoke.mla_setup()
    assert len(want["steps"]) == chip_smoke.SERVE_NEW
    for rec in want["steps"]:
        assert np.asarray(rec["ids"]).shape == (chip_smoke.SERVE_B, 5)
    cfg = chip_smoke.mla_config(get_config(chip_smoke.MLA_ARCH))
    m, E, B = cfg.mla, cfg.moe.n_experts, chip_smoke.SERVE_B
    T = B * chip_smoke.SERVE_S
    z = np.load(chip_smoke.MLA_ROUTING)
    assert int(z["capacity"]) == moe_capacity(cfg, T, decode=False)
    assert z["moe_layers"].tolist() == [1] and int(z["n_layers"]) == 2
    assert z["prefill_scores"].shape == (1, 1, T, E)
    assert z["prefill_token_unstable"].shape == (1, T)
    assert z["prefill_flips"].tolist() == [int(z["prefill_token_unstable"].sum())]
    assert z["decode_dispatch"].shape == (chip_smoke.SERVE_NEW - 1, 1, 1, B,
                                          E)
    assert z["skewed_scores"].shape == (T, E)
    assert z["skewed_auction_prices"].max() > 0
    P = len(chip_smoke.sample_positions())
    assert z["layer0_positions"].tolist() == \
        chip_smoke.sample_positions().tolist()
    assert z["layer0_hidden"].shape == (B, P, cfg.d_model)
    assert z["layer0_c_kv"].shape == (B, P, m.kv_lora_rank)
    assert z["layer0_k_rope"].shape == (B, P, m.qk_rope_dim)
    assert chip_smoke.MLA_ROUTING.stat().st_size + \
        chip_smoke.MLA_CONSTANTS.stat().st_size < 16 << 20


def test_mamba_constants_fit_the_smoke():
    """The committed mamba2 constants were made for the SSM phase's setup
    (full width and depth): every step and request of the JSON; in the
    npz the ``state`` and ``conv`` rows of layers SSM_LAYERS for the
    first SSM_REQUESTS requests, at mamba2-370m's widths."""
    want = json.loads(chip_smoke.SSM_CONSTANTS.read_text())
    assert {k: want[k] for k in chip_smoke.ssm_setup()} == \
        chip_smoke.ssm_setup()
    assert len(want["steps"]) == chip_smoke.SERVE_NEW
    for rec in want["steps"]:
        assert np.asarray(rec["ids"]).shape == (chip_smoke.SERVE_B, 5)
    cfg = get_config(chip_smoke.SSM_ARCH)
    s, L, R = cfg.ssm, len(chip_smoke.SSM_LAYERS), chip_smoke.SSM_REQUESTS
    di = s.d_inner(cfg.d_model)
    assert chip_smoke.SSM_LAYERS == (0, cfg.n_layers - 1)
    z = np.load(chip_smoke.SSM_STATES)
    assert z["layers"].tolist() == list(chip_smoke.SSM_LAYERS)
    assert z["state"].shape == (L, R, s.n_heads(cfg.d_model), s.head_dim,
                                s.d_state)
    assert z["conv"].shape == (L, R, s.d_conv - 1, di + 2 * s.d_state)
    assert z["state"].dtype == z["conv"].dtype == np.float32
    assert np.abs(z["state"]).max() > 0


@pytest.mark.parametrize("fault", ["B and C swapped", "decay doubled",
                                   "conv cache one row early"])
def test_check_ssm_rows_and_serve_catch_wrong_ssd(fault, monkeypatch):
    """The SSM phase's checks have teeth: an SSD that swaps B and C or
    doubles the decay moves the prefill's state rows past
    ``check_ssm_rows``' tolerance and the logits past ``check_serve``'s; a
    conv cache taken one row early moves the conv rows and the decode
    steps. mamba2's smoke variant at 2 layers, 2 prompts of 128 tokens (2
    SSD chunks)."""
    from repro_torch.models import mamba
    cfg = dataclasses.replace(smoke_variant(get_config("mamba2-370m")),
                              n_layers=2)
    monkeypatch.setattr(chip_smoke, "SSM_LAYERS", (0, 1))
    model = model_from_params(cfg, numpy_params(cfg, seed=0), device="cpu")
    prompts = torch.tensor(chip_smoke.serve_prompts(cfg.vocab, 2, 128))
    rows = chip_smoke.ssm_rows(model, prompts, 132)
    steps, *_ = chip_smoke.port_serve(model, prompts, 4, 132)
    want_rows = dict(rows, layers=np.array([0, 1]))
    want = [chip_smoke.top5_records(lg) for _, lg in steps]
    chip_smoke.check_ssm_rows(rows, want_rows)
    chip_smoke.check_serve(steps, want)
    ssd, conv = mamba._ssd_chunked, mamba._causal_conv

    def early(u, w, b, cache_conv=None):
        out, c = conv(u, w, b, cache_conv)
        if cache_conv is not None:
            return out, c
        K = w.shape[0]
        up = torch.cat([u.new_zeros((u.shape[0], K - 1, u.shape[2])), u], 1)
        return out, up[:, -K:-1]
    wrong = {
        "B and C swapped": ("_ssd_chunked", lambda xh, dt, A, Bm, Cm, chunk,
                            init_state=None: ssd(xh, dt, A, Cm, Bm, chunk,
                                                 init_state)),
        "decay doubled": ("_ssd_chunked", lambda xh, dt, A, Bm, Cm, chunk,
                          init_state=None: ssd(xh, dt, 2 * A, Bm, Cm, chunk,
                                               init_state)),
        "conv cache one row early": ("_causal_conv", early),
    }[fault]
    monkeypatch.setattr(mamba, *wrong)
    bad_rows = chip_smoke.ssm_rows(model, prompts, 132)
    bad, *_ = chip_smoke.port_serve(model, prompts, 4, 132)
    with pytest.raises(AssertionError, match="layer 0 SSM"):
        chip_smoke.check_ssm_rows(bad_rows, want_rows)
    with pytest.raises(AssertionError):
        chip_smoke.check_serve(bad, want)


def _moe_marks(n_steps=4, L=2, B=3):
    return {"prefill_unstable": np.zeros(L, bool),
            "prefill_flips": np.zeros(L, np.int32),
            "decode_unstable": np.zeros((n_steps - 1, L, B), bool),
            "prefill_dispatch": np.zeros((L, 1, 5, 4), bool),
            "decode_dispatch": np.zeros((n_steps - 1, L, 1, B, 4), bool)}


def test_moe_stops_follow_the_routing_marks():
    """Nothing is compared past an unstable prefill; a request stops at
    its first decode step whose routing is unstable in any layer."""
    marks = _moe_marks()
    assert chip_smoke.moe_stops(marks) == ([4, 4, 4],
                                           "every step's routing stable")
    marks["decode_unstable"][1, 1, 2] = True
    stops, why = chip_smoke.moe_stops(marks)
    assert stops == [4, 4, 2] and "request 2 from step 2" in why
    marks["prefill_unstable"][1], marks["prefill_flips"][1] = True, 7
    stops, why = chip_smoke.moe_stops(marks)
    assert stops == [0, 0, 0] and "layer 1 (7 tokens move)" in why


def _token_marks(mark=None, B=3, S=5, E=4, cap=10, layer=1, demand=8,
                 price=0.0):
    """One MoE layer's marks as the deepseek constants hold them: the
    model's layer ``layer`` of 2, capacity ``cap``, the auction's largest
    demand and price, and a mark at token ``mark`` (``b * S + s``)."""
    marks = _moe_marks(L=1, B=B)
    marks["prefill_dispatch"] = np.zeros((1, 1, B * S, E), bool)
    marks["prefill_token_unstable"] = np.zeros((1, B * S), bool)
    if mark is not None:
        marks["prefill_token_unstable"][0, mark] = True
        marks["prefill_unstable"][0], marks["prefill_flips"][0] = True, 1
    marks.update(moe_layers=np.array([layer]), n_layers=np.int32(2),
                 capacity=np.int32(cap),
                 prefill_auction_demand=np.array([[[demand, 0, 0, 0]]]),
                 prefill_auction_prices=np.array([[[price, 0, 0, 0]]],
                                                 np.float32))
    return marks


@pytest.mark.parametrize("case,want", [
    ("no mark", [4, 4, 4]),
    ("a non-last position of the last layer, slack capacity", [4, 4, 4]),
    ("request 1's last position", [4, 0, 4]),
    ("binding capacity", [0, 0, 0]),
    ("a raised price", [0, 0, 0]),
    ("an earlier layer", [0, 0, 0]),
])
def test_moe_stops_follow_the_token_marks(case, want):
    """The exact rule for per-token marks: a mark in the model's last
    layer, where the auction's largest demand is below capacity - 1 and no
    price rose, moves only its own token's last hidden row, so it stops
    only the request whose last prompt position it is (the prefill reads
    only that row's logits); a binding capacity, a raised price or an
    earlier layer stops every request at step 0."""
    marks = _token_marks(**{
        "no mark": {},
        "a non-last position of the last layer, slack capacity":
            dict(mark=7),
        "request 1's last position": dict(mark=9),
        "binding capacity": dict(mark=7, demand=9),
        "a raised price": dict(mark=7, price=0.25),
        "an earlier layer": dict(mark=7, layer=0),
    }[case])
    stops, why = chip_smoke.moe_stops(marks)
    assert stops == want, why
    if case == "request 1's last position":
        assert "requests [1] not compared" in why
        # the prefill dispatch is compared but for the marked token's row
        seen = [("auction_route", 3, torch.zeros(1, 15, 4, dtype=torch.bool))]
        seen += [("topk_route", 3, torch.zeros(1, 3, 4, dtype=torch.bool))
                 for _ in range(3)]
        assert chip_smoke.check_moe_dispatch(seen, marks, stops, 1) == 14 + 6
        seen[0][2][0, 9, 0] = True
        assert chip_smoke.check_moe_dispatch(seen, marks, stops, 1) == 14 + 6
        seen[0][2][0, 8, 0] = True
        with pytest.raises(AssertionError, match="prefill layer 0"):
            chip_smoke.check_moe_dispatch(seen, marks, stops, 1)


def test_moe_stops_of_phi_constants_unchanged():
    """phi3.5-moe's committed constants hold no per-token marks: their
    stops are what the rule gave before it had them (no decision marked,
    every step compared)."""
    z = dict(np.load(chip_smoke.MOE_ROUTING))
    assert "prefill_token_unstable" not in z
    assert chip_smoke.moe_stops(z) == ([chip_smoke.SERVE_NEW]
                                       * chip_smoke.SERVE_B,
                                       "every step's routing stable")
    assert chip_smoke.local_marks(z, 0) is None


def test_check_moe_dispatch_fails_on_a_flip_where_jax_was_stable():
    marks = _moe_marks()
    seen = ([("auction_route", 3, torch.tensor(d))
             for d in marks["prefill_dispatch"]]
            + [("topk_route", 3, torch.tensor(marks["decode_dispatch"][t, i]))
               for t in range(3) for i in range(2)])
    assert chip_smoke.check_moe_dispatch(seen, marks, [4, 4, 4], 2) == \
        2 * 5 + 3 * 2 * 3
    seen[2 + 2 * 1 + 1][2][0, 2, 0] = True      # decode step 2, layer 1
    with pytest.raises(AssertionError, match="step 2 layer 1 request 2"):
        chip_smoke.check_moe_dispatch(seen, marks, [4, 4, 4], 2)
    # not compared past request 2's stop
    assert chip_smoke.check_moe_dispatch(seen, marks, [4, 4, 2], 2) == \
        2 * 5 + 3 * 2 * 2 + 2
    seen[0][2][0, 0, 0] = True                  # prefill layer 0
    with pytest.raises(AssertionError, match="prefill layer 0"):
        chip_smoke.check_moe_dispatch(seen, marks, [2, 2, 2], 2)
    assert chip_smoke.check_moe_dispatch(seen, marks, [0, 0, 0], 2) == 0


def test_unmarked_flips_count_only_stable_decisions():
    """``chip_smoke.unmarked_flips`` counts the port's own routing
    decisions off JAX's where JAX's marks call them stable: a prefill row
    unless its token is marked, a decode row while the request's tokens
    fed so far are JAX's and its decision is not marked."""
    marks = _moe_marks()
    marks["prefill_scores"] = np.zeros((2, 1, 5, 4), np.float32)
    marks["prefill_token_unstable"] = np.zeros((2, 5), bool)
    seen = ([("auction_route", 3, torch.tensor(d))
             for d in marks["prefill_dispatch"]]
            + [("topk_route", 3, torch.tensor(marks["decode_dispatch"][t, i]))
               for t in range(3) for i in range(2)])
    tokens = np.zeros((3, 4), np.int32)
    got = chip_smoke.unmarked_flips(seen, marks, tokens, tokens)
    assert (got["prefill"], got["prefill_rows"]) == (0, 10)
    assert (got["decode"], got["decode_rows"]) == (0, 3 * 2 * 3)
    seen[1][2][0, 3, 2] = True                  # prefill layer 1, token 3
    seen[2 + 2 * 1 + 0][2][0, 1, 0] = True      # decode step 2, layer 0
    got = chip_smoke.unmarked_flips(seen, marks, tokens, tokens)
    assert got["prefill"] == 1 and got["prefill_at"] == [(1, 3)]
    assert got["decode"] == 1 and got["decode_at"] == [(2, 0, 1)]
    marks["prefill_token_unstable"][1, 3] = True
    marks["decode_unstable"][1, 0, 1] = True
    got = chip_smoke.unmarked_flips(seen, marks, tokens, tokens)
    assert (got["prefill"], got["prefill_rows"]) == (0, 9)
    assert (got["decode"], got["decode_rows"]) == (0, 3 * 2 * 3 - 1)
    other = tokens.copy()
    other[2, 1] = 7             # request 2 leaves JAX's tokens at token 1
    got = chip_smoke.unmarked_flips(seen, marks, other, tokens)
    assert got["decode_rows"] == 3 * 2 * 3 - 1 - 2 * 2


def test_check_serve_stops_where_told():
    rng = np.random.default_rng(1)
    logits = [rng.normal(size=(2, 50)).astype(np.float32) for _ in range(3)]
    want = [chip_smoke.top5_records(lg) for lg in logits]
    bad = [(np.argmax(lg, -1), lg.copy()) for lg in logits]
    bad[2][1][1] = -bad[2][1][1]           # request 1 differs at step 2
    with pytest.raises(AssertionError):
        chip_smoke.check_serve(bad, want)
    report = chip_smoke.check_serve(bad, want, stop=[3, 2])
    assert report["steps_compared"] == [3, 2]


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


def test_serve_cli_on_cpu():
    proc = _cli("--arch", "smollm-135m", "--smoke", "--batch", "2",
                "--prompt-len", "8", "--max-new", "4", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("prefill: 2x8 in ")
    assert lines[1].startswith("decode: 3 steps in ")
    assert lines[2] == "sample generations (token ids):"
    assert [ln.split(":")[0] for ln in lines[3:]] == ["  req0", "  req1"]


def test_serve_cli_on_cpu_moe():
    """phi3.5-moe's smoke variant through the CLI, its depth cut to 2
    layers: flow routing in the prefill, top-k in the decode steps."""
    proc = _cli("--arch", "phi3.5-moe-42b-a6.6b", "--smoke", "--n-layers",
                "2", "--batch", "2", "--prompt-len", "8", "--max-new", "4",
                "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("prefill: 2x8 in ")
    assert lines[1].startswith("decode: 3 steps in ")
    assert [ln.split(":")[0] for ln in lines[3:]] == ["  req0", "  req1"]


def test_serve_cli_on_cpu_deepseek():
    """deepseek-v2's smoke variant through the CLI, its depth cut to 2
    layers: the dense prefix, then MLA with the MoE."""
    proc = _cli("--arch", "deepseek-v2-236b", "--smoke", "--n-layers", "2",
                "--batch", "2", "--prompt-len", "8", "--max-new", "4",
                "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("prefill: 2x8 in ")
    assert lines[1].startswith("decode: 3 steps in ")
    assert [ln.split(":")[0] for ln in lines[3:]] == ["  req0", "  req1"]


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-v0.1-52b"])
def test_serve_cli_on_cpu_ssm(arch):
    """mamba2's smoke variant (4 mamba layers) and jamba's (16 layers:
    attention at 0 and 8, mamba elsewhere, the MoE at every other layer)
    through the CLI: SSD prefill and recurrent decode."""
    proc = _cli("--arch", arch, "--smoke", "--batch", "2", "--prompt-len",
                "8", "--max-new", "4", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("prefill: 2x8 in ")
    assert lines[1].startswith("decode: 3 steps in ")
    assert [ln.split(":")[0] for ln in lines[3:]] == ["  req0", "  req1"]


def test_serve_cli_unported_family_raises():
    """The one family the serve path lacks, the encoder (hubert-xlarge,
    ROADMAP M9), is refused: it has no decode path."""
    proc = _cli("--arch", "hubert-xlarge", "--smoke", "--device", "cpu")
    assert proc.returncode != 0
    assert "encoder archs have no decode path" in proc.stderr
