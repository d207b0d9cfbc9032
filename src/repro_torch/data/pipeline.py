"""Deterministic synthetic data pipeline (stateless, so trivially resumable).

Counterpart of ``repro/data/pipeline.py``, the port's own numpy copy: the
same rows, byte for byte. Every row of every batch is a pure function of
(seed, step, row index), so a restart needs no iterator state (resume =
set the step) and any split of the batch into shards gives the same rows.

The token stream is a mixture of Zipf-distributed unigrams and copied
spans, so losses go down in example runs (structure to learn). With
``frontend_dim`` a row is frame embeddings and labels instead.

``make_batch`` puts one global batch on a device, in place of the JAX
package's ``make_global_batch`` (which builds a batch sharded over a
mesh; one card has none).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    copy_prob: float = 0.3
    frontend_dim: int = 0     # audio stub: emit frame embeddings instead


def _row_rng(cfg: DataConfig, step: int, row: int):
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, row]))


def _token_row(cfg: DataConfig, step: int, row: int):
    rng = _row_rng(cfg, step, row)
    toks = rng.zipf(cfg.zipf_a, size=cfg.seq_len + 1)
    toks = np.minimum(toks - 1, cfg.vocab - 1).astype(np.int32)
    if rng.random() < cfg.copy_prob:
        L = max(1, cfg.seq_len // 4)
        hi1 = max(1, cfg.seq_len // 2 - L)
        src = rng.integers(0, hi1)
        dst = rng.integers(cfg.seq_len // 2, max(cfg.seq_len // 2 + 1,
                                                 cfg.seq_len - L))
        span = min(L, cfg.seq_len + 1 - dst)
        toks[dst:dst + span] = toks[src:src + span]
    return toks


def _embed_row(cfg: DataConfig, step: int, row: int):
    rng = _row_rng(cfg, step, row)
    emb = rng.normal(size=(cfg.seq_len, cfg.frontend_dim)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, size=cfg.seq_len).astype(np.int32)
    return emb, labels


def rows_batch(cfg: DataConfig, step: int, start: int, stop: int):
    """Rows [start, stop) of global batch `step` — numpy dict."""
    if cfg.frontend_dim:
        pairs = [_embed_row(cfg, step, r) for r in range(start, stop)]
        return {"embeds": np.stack([p[0] for p in pairs]),
                "labels": np.stack([p[1] for p in pairs])}
    toks = np.stack([_token_row(cfg, step, r) for r in range(start, stop)])
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def host_batch(cfg: DataConfig, step: int, shard: int, n_shards: int):
    """Shard ``shard`` of ``n_shards``: a contiguous slice of global batch
    ``step``."""
    if cfg.global_batch % n_shards:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"into {n_shards} shards")
    local = cfg.global_batch // n_shards
    return rows_batch(cfg, step, shard * local, (shard + 1) * local)


def make_batch(cfg: DataConfig, step: int, device=None) -> dict:
    """Global batch ``step`` as tensors on ``device`` (default cuda):
    ``tokens`` (or ``embeds``) and ``labels``, int32 (embeds float32)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for k, x in rows_batch(cfg, step, 0, cfg.global_batch).items()}
