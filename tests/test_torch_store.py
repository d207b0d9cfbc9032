"""The checkpoint store (``repro_torch.checkpoint.store``) on tensors.

The cases of ``tests/test_checkpoint.py`` (the reference store's own
tests), on the port: atomic commit with the manifest written last, a
failed write leaving no temp directory, rotation that orders by step and
touches only ``step_<digits>`` directories, ``latest_step``, restore that
refuses a dtype, shape, leaf-count or manifest mismatch, and the keyed
blob store. Where the reference re-places leaves on a mesh, the port
restores onto ``device=``.

Both stores write the same layout (``shard_0.npz`` of ``leaf_<i>`` in
``jax.tree.leaves`` order, a manifest of numpy dtype strings), so an
entry one package writes reads back bit for bit in the other: checked
both ways for a step checkpoint and for the three solver kinds' cached
solutions. Tolerance: exact equality, dtypes included.
"""
from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same

from repro.checkpoint import store as jstore
from repro_torch.checkpoint import store
from repro_torch.core.batch import solve_batch
from repro_torch.core.kinds import get_kind
from repro_torch.core.masking import tree_map
from repro_torch.core.matching.ref import random_bipartite
from repro_torch.core.maxflow.grid import GridProblem
from repro_torch.core.maxflow.ref import random_grid_problem

CPU = "cpu"


def _tree():
    return {"w": torch.arange(24.0, dtype=torch.float32).reshape(4, 6),
            "opt": {"mu": torch.ones((4, 6), dtype=torch.float32),
                    "count": torch.tensor(3, dtype=torch.int32)}}


# ------------------------------------------------------- atomic commit


def test_commit_is_atomic_and_manifest_marks_completion(tmp_path):
    store.save(str(tmp_path), 1, _tree())
    path = tmp_path / "step_00000001"
    assert (path / "manifest.json").exists()
    meta = json.loads((path / "manifest.json").read_text())
    assert meta["n_leaves"] == 3 and meta["step"] == 1
    # numpy dtype strings, in jax.tree.leaves order (sorted dict keys)
    assert meta["dtypes"] == ["int32", "float32", "float32"]
    assert meta["shapes"] == [[], [4, 6], [4, 6]]
    assert sorted(os.listdir(path)) == ["manifest.json", "shard_0.npz"]
    # no tempdir residue after a successful commit
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp_")]
    # a torn write (dir without manifest) is INVISIBLE to latest_step
    os.makedirs(tmp_path / "step_00000002")
    assert store.latest_step(str(tmp_path)) == 1
    # ... and an in-flight tempdir is too
    os.makedirs(tmp_path / ".tmp_ckpt_inflight")
    assert store.latest_step(str(tmp_path)) == 1


def test_failed_write_leaves_no_tempdir(tmp_path):
    class Boom:
        """A leaf whose materialization raises mid-write."""
        dtype = np.float32

        def __array__(self, *a, **k):
            raise RuntimeError("device fell over")

    with pytest.raises(RuntimeError, match="device fell over"):
        store.save(str(tmp_path), 5, {"x": Boom()})
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp_")]
    assert store.latest_step(str(tmp_path)) is None


# ------------------------------------------------------- GC namespacing


def test_gc_keeps_newest_in_step_order(tmp_path):
    tree = {"x": torch.zeros(2)}
    # out-of-order saves: GC must order by STEP NUMBER, not mtime
    for s in (3, 1, 4, 0, 2):
        store.save(str(tmp_path), s, tree, keep=2)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]


def test_gc_skips_kv_and_foreign_dirs(tmp_path):
    store.put(str(tmp_path), "deadbeef", [np.arange(3)])
    os.makedirs(tmp_path / "users_notes")
    (tmp_path / "users_notes" / "todo.txt").write_text("keep me")
    (tmp_path / "loose_file").write_text("me too")
    tree = {"x": torch.zeros(2)}
    for s in range(4):
        store.save(str(tmp_path), s, tree, keep=1)
    names = set(os.listdir(tmp_path))
    assert "kv_deadbeef" in names
    assert "users_notes" in names and "loose_file" in names
    assert [d for d in names if d.startswith("step_")] == ["step_00000003"]
    got = store.get(str(tmp_path), "deadbeef")
    np.testing.assert_array_equal(got[0], np.arange(3))


def test_latest_step_ignores_foreign_dirs(tmp_path):
    store.save(str(tmp_path), 7, {"x": torch.zeros(2)})
    os.makedirs(tmp_path / "step_notanumber")
    os.makedirs(tmp_path / "stepping_stone")
    os.makedirs(tmp_path / "kv_abc123")
    assert store.latest_step(str(tmp_path)) == 7
    assert store.latest_step(str(tmp_path / "does_not_exist")) is None


# ------------------------------------------------------- validated restore


def test_restore_roundtrip_onto_a_device(tmp_path):
    tree = _tree()
    store.save(str(tmp_path), 1, tree)
    back = store.restore(str(tmp_path), 1, tree, device=CPU)
    assert_same(back, tree)
    assert back["opt"]["count"].dtype == torch.int32
    assert back["w"].device.type == "cpu"
    # numpy likes restore as tensors too
    back = store.restore(str(tmp_path), 1,
                         tree_map(lambda a: a.numpy(), tree), device=CPU)
    assert isinstance(back["w"], torch.Tensor)
    assert_same(back, tree)


def test_restore_without_card_raises(tmp_path, monkeypatch):
    store.save(str(tmp_path), 1, _tree())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        store.restore(str(tmp_path), 1, _tree())


def test_restore_rejects_dtype_mismatch(tmp_path):
    store.save(str(tmp_path), 1, _tree())
    wrong = tree_map(lambda a: a.to(torch.int32), _tree())
    with pytest.raises(ValueError, match="refusing to cast"):
        store.restore(str(tmp_path), 1, wrong, device=CPU)


def test_restore_rejects_shape_mismatch(tmp_path):
    store.save(str(tmp_path), 1, _tree())
    wrong = _tree()
    wrong["w"] = torch.zeros((6, 4), dtype=torch.float32)
    with pytest.raises(ValueError, match="mismatch"):
        store.restore(str(tmp_path), 1, wrong, device=CPU)


def test_restore_rejects_leaf_count_mismatch(tmp_path):
    store.save(str(tmp_path), 1, _tree())
    with pytest.raises(ValueError, match="leaves"):
        store.restore(str(tmp_path), 1, {"only": torch.zeros(2)},
                      device=CPU)


def test_restore_rejects_corrupt_shard(tmp_path):
    store.save(str(tmp_path), 1, _tree())
    path = tmp_path / "step_00000001"
    # tamper: manifest claims a different shape than the shard holds
    meta = json.loads((path / "manifest.json").read_text())
    meta["shapes"][0] = [9, 9]
    (path / "manifest.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="corrupt checkpoint|mismatch"):
        store.restore(str(tmp_path), 1, _tree(), device=CPU)


def test_kv_roundtrip_and_key_validation(tmp_path):
    tree = {"sol": torch.arange(5.0), "meta": torch.tensor(2,
                                                           dtype=torch.int32)}
    store.put(str(tmp_path), "cafe.01-x", tree)
    back = store.get(str(tmp_path), "cafe.01-x", like_tree=tree, device=CPU)
    assert_same(back, tree)
    assert store.get(str(tmp_path), "absent") is None
    with pytest.raises(ValueError, match="invalid blob key"):
        store.put(str(tmp_path), "../escape", tree)
    # overwrite is atomic and last-write-wins
    store.put(str(tmp_path), "cafe.01-x", tree_map(lambda a: a + 1, tree))
    back = store.get(str(tmp_path), "cafe.01-x", like_tree=tree, device=CPU)
    assert_same(back["sol"], np.arange(5.0, dtype=np.float32) + 1)
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp_")]


# ------------------------------------------------------- cross-read


def test_step_checkpoint_reads_across_packages(tmp_path):
    """A step the port saves restores in the JAX package and the other way
    round, leaf for leaf, and the two manifests are identical."""
    tree = _tree()
    store.save(str(tmp_path / "t"), 4, tree)
    jtree = {"w": jnp.asarray(tree["w"].numpy()),
             "opt": {"mu": jnp.asarray(tree["opt"]["mu"].numpy()),
                     "count": jnp.int32(3)}}
    assert_same(store.restore(str(tmp_path / "t"), 4, tree, device=CPU),
                jstore.restore(str(tmp_path / "t"), 4, jtree))
    jstore.save(str(tmp_path / "j"), 4, jtree)
    assert_same(store.restore(str(tmp_path / "j"), 4, tree, device=CPU),
                tree)
    meta = [json.loads((tmp_path / d / "step_00000004" / "manifest.json")
                       .read_text()) for d in ("t", "j")]
    assert meta[0] == meta[1]


def _solutions():
    """One cropped result's cacheable solution per kind (port, CPU)."""
    rng = np.random.default_rng(0)
    payloads = {"maxflow": GridProblem(*random_grid_problem(rng, 6, 7)),
                "assignment": rng.integers(0, 50, (6, 6)),
                "matching": random_bipartite(rng, 8, 7, 0.3)}
    return {kind: get_kind(kind).solution_of(
        solve_batch(kind, [p], device=CPU)[0])
        for kind, p in payloads.items()}


@pytest.mark.parametrize("kind", ["maxflow", "assignment", "matching"])
def test_solutions_cross_read_both_ways(tmp_path, kind):
    """A ``put`` of a kind's solution by the port is read by the JAX
    package's ``get`` (flat and with a like tree), and a ``put`` by the
    JAX package is read by the port's, bit for bit."""
    sol = _solutions()[kind]
    jsol = {k: jnp.asarray(v.numpy()) for k, v in sol.items()}
    store.put(str(tmp_path), "from_port", sol)
    flat = jstore.get(str(tmp_path), "from_port")
    assert_same(flat, [sol[k] for k in sorted(sol)])
    assert_same(jstore.get(str(tmp_path), "from_port", like_tree=jsol), sol)
    jstore.put(str(tmp_path), "from_jax", jsol)
    assert_same(store.get(str(tmp_path), "from_jax", like_tree=sol,
                          device=CPU), sol)
    assert_same(store.get(str(tmp_path), "from_jax"),
                [sol[k] for k in sorted(sol)])
