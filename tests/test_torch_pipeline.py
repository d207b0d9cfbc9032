"""The port's data pipeline (``repro_torch.data.pipeline``) against the
JAX package's: the same rows byte for byte (both are numpy from the same
seed sequence), tokens and frame embeddings, and shards that concatenate
to the global batch."""
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe

CFGS = [dict(vocab=1000, seq_len=64, global_batch=8),
        dict(vocab=49152, seq_len=33, global_batch=6, seed=3),
        dict(vocab=50, seq_len=5, global_batch=4, copy_prob=1.0),
        dict(vocab=500, seq_len=16, global_batch=4, frontend_dim=12)]


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("kw", CFGS)
@pytest.mark.parametrize("step", [0, 7])
def test_rows_batch_byte_equal(kw, step):
    jc, tc = jpipe.DataConfig(**kw), tpipe.DataConfig(**kw)
    _same(tpipe.rows_batch(tc, step, 1, 3), jpipe.rows_batch(jc, step, 1, 3))
    for shard in range(2):
        _same(tpipe.host_batch(tc, step, shard, 2),
              jpipe.host_batch(jc, step, shard, 2))


@pytest.mark.parametrize("kw", CFGS)
def test_shards_concatenate_to_the_global_batch(kw):
    tc = tpipe.DataConfig(**kw)
    whole = tpipe.rows_batch(tc, 2, 0, tc.global_batch)
    for n in (1, 2, tc.global_batch):
        parts = [tpipe.host_batch(tc, 2, s, n) for s in range(n)]
        _same({k: np.concatenate([p[k] for p in parts]) for k in whole},
              whole)
    got = tpipe.make_batch(tc, 2, "cpu")
    _same({k: v.numpy() for k, v in got.items()}, whole)
    assert all(v.device.type == "cpu" for v in got.values())
    key = "embeds" if tc.frontend_dim else "tokens"
    assert got[key].dtype == (torch.float32 if tc.frontend_dim
                              else torch.int32)


def test_labels_are_the_next_tokens():
    tc = tpipe.DataConfig(vocab=100, seq_len=20, global_batch=3)
    b = tpipe.rows_batch(tc, 0, 0, 3)
    assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert b["tokens"].max() < 100 and b["tokens"].min() >= 0


def test_host_batch_refuses_uneven_shards():
    with pytest.raises(ValueError, match="shards"):
        tpipe.host_batch(tpipe.DataConfig(10, 4, 6), 0, 0, 4)
