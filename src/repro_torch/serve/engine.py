"""Serving: batched model prefill and greedy decode.

Counterpart of ``repro/serve/engine.py``, its LLM half:
``make_prefill_step`` runs the prompt through the model (K6 attention on
the card) and fills the KV caches, ``make_serve_step`` decodes one new
token for every request against them, ``greedy_generate`` loops the two.
The solver half (``SolverEngine``) waits for ROADMAP M8; the layer it
rides, ``repro_torch.core.batch`` and ``repro_torch.core.refill``, is here.

The JAX steps take the params tree as an argument; here the parameters
live in the ``Model``, so the step makers take the model. Steps run under
``torch.inference_mode`` and update the caches in place (see
``models/attention.py``).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models.model import Model, apply_model, init_caches


class ServeState(NamedTuple):
    caches: Any
    last_tokens: torch.Tensor   # (B,) int32, most recent token per request
    lengths: torch.Tensor       # (B,) int32, current sequence lengths
    # (B, vocab) logits that chose last_tokens; the port keeps them so a
    # caller can check a step against a reference (the JAX state has none)
    logits: Optional[torch.Tensor] = None


def _greedy(logits):
    """First maximum per row, as ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_prefill_step(model: Model):
    @torch.inference_mode()
    def prefill(tokens, caches):
        """tokens: (B, S). Returns (first generated token, ServeState)."""
        out = apply_model(model, {"tokens": tokens}, caches=caches,
                          logits_mode="last")
        last = out.logits[:, -1]
        nxt = _greedy(last)
        B, S = tokens.shape
        return nxt, ServeState(out.caches, nxt,
                               torch.full((B,), S, dtype=torch.int32,
                                          device=tokens.device), last)
    return prefill


def make_serve_step(model: Model):
    """Decode one token for the whole batch.

    The position comes from ``state.lengths[0]`` on the device (no host
    sync), so one step serves every decode position.
    """
    @torch.inference_mode()
    def serve_step(state: ServeState):
        out = apply_model(model, {"tokens": state.last_tokens[:, None]},
                          caches=state.caches, decode=True,
                          pos_offset=state.lengths[0], logits_mode="last")
        last = out.logits[:, -1]
        nxt = _greedy(last)
        return nxt, ServeState(out.caches, nxt, state.lengths + 1, last)
    return serve_step


@torch.inference_mode()
def greedy_generate(model: Model, prompt_tokens, max_new: int):
    """Reference end-to-end generation loop: ``(B, max_new)`` int32 tokens
    on the prompts' device."""
    B, S = prompt_tokens.shape
    caches = init_caches(model.cfg, B, S + max_new + 1, dtype=torch.float32,
                         device=prompt_tokens.device)
    nxt, state = make_prefill_step(model)(prompt_tokens, caches)
    step = make_serve_step(model)
    toks = [nxt]
    for _ in range(max_new - 1):
        nxt, state = step(state)
        toks.append(nxt)
    return torch.stack(toks, dim=1)
