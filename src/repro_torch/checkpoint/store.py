"""Checkpointing: npz + JSON manifest, atomic commit, on tensors.

Counterpart of ``repro/checkpoint/store.py`` with the SAME on-disk layout,
so an entry written by one package reads back bit for bit in the other:

    <dir>/step_<N>/shard_0.npz + manifest.json (written LAST: its presence
    marks the checkpoint complete; partial writes are never visible)

``shard_0.npz`` holds ``leaf_<i>`` arrays in ``jax.tree.leaves`` order
(``repro_torch.core.masking.tree_flatten``: dicts in sorted key order,
``None`` dropped); ``manifest.json`` holds ``n_leaves`` and per leaf the
numpy dtype string (``"int32"``, never ``"torch.int32"``) and the shape.
The port runs as one process, so its shard is always ``shard_0``.

``restore`` VALIDATES each leaf against the manifest's ``dtypes`` /
``shapes`` and against ``like_tree`` before building any tensor: a dtype
or shape mismatch raises ``ValueError`` naming the leaf instead of
casting. Where the reference re-places leaves with ``shardings=``, the
port takes ``device=`` (the card unless ``"cpu"``).

Beyond step checkpoints the store is a flat keyed blob store for the
warm-start solution cache (``repro_torch.core.warm.SolutionCache`` spills
evicted entries here): ``put(dir, key, tree)`` / ``get(dir, key,
like_tree=None)`` write ``kv_<key>/`` entries with the same atomic commit
and manifest. ``_gc`` only ever touches ``step_<digits>`` directories, so
kv entries and foreign directories survive checkpoint rotation.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.masking import tree_flatten, tree_unflatten

# the only directories save/restore/_gc own; anything else in ckpt_dir
# (kv_* entries, foreign dirs, loose files) is never GC'd or parsed
_STEP_RE = re.compile(r"^step_(\d{8,})$")
_SHARD = "shard_0.npz"        # one process: the reference's process 0


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _np_dtype(leaf) -> np.dtype:
    """The numpy dtype of a tensor or array leaf (``int32``, not
    ``torch.int32``)."""
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.dtype(leaf.dtype)


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Blocking save of a tree of tensors or arrays. Returns the path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    leaves, _ = tree_flatten(tree)
    _write_entry(ckpt_dir, final, leaves, extra_meta={"step": step})
    _gc(ckpt_dir, keep)
    return final


def _write_entry(ckpt_dir: str, final: str, leaves, *, extra_meta=None):
    """Write leaves + manifest into ``final`` with an atomic commit."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_ckpt_")
    try:
        arrs = {f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
        np.savez(os.path.join(tmp, _SHARD), **arrs)
        meta = {
            "n_leaves": len(leaves),
            "dtypes": [str(arrs[f"leaf_{i}"].dtype)
                       for i in range(len(leaves))],
            "shapes": [list(arrs[f"leaf_{i}"].shape)
                       for i in range(len(leaves))],
        }
        meta.update(extra_meta or {})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(meta, f)
        try:
            os.replace(tmp, final)        # atomic commit
        except OSError:
            # target exists as a non-empty dir (kv overwrite): swap the
            # old entry aside first so the commit itself stays a single
            # atomic rename, then drop the displaced entry
            old = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_old_")
            os.replace(final, os.path.join(old, "prev"))
            os.replace(tmp, final)
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _gc(ckpt_dir: str, keep: int):
    # skip anything that is not a committed step directory: kv_* blob
    # entries, users' foreign dirs and in-flight .tmp_* writes must never
    # be collected by checkpoint rotation
    steps = sorted(d for d in os.listdir(ckpt_dir) if _STEP_RE.match(d))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for d in os.listdir(ckpt_dir):
        m = _STEP_RE.match(d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            best = max(best or -1, int(m.group(1)))
    return best


def _load_validated(path: str, like_leaves, meta):
    """Load the shard's leaves (numpy), validating dtype/shape against the
    manifest and, unless ``like_leaves`` is ``None`` (the keyed blob path,
    where the caller holds the structure), against the likes."""
    n = meta["n_leaves"]
    if like_leaves is not None and len(like_leaves) != n:
        raise ValueError(
            f"checkpoint/model mismatch at {path}: checkpoint has {n} "
            f"leaves, like_tree has {len(like_leaves)}")
    data = np.load(os.path.join(path, _SHARD))
    out = []
    for i in range(n):
        arr = data[f"leaf_{i}"]
        want_dtype, want_shape = meta["dtypes"][i], tuple(meta["shapes"][i])
        if str(arr.dtype) != want_dtype or arr.shape != want_shape:
            raise ValueError(
                f"corrupt checkpoint {path}: leaf {i} is "
                f"{arr.dtype}{list(arr.shape)} but the manifest recorded "
                f"{want_dtype}{list(want_shape)}")
        if like_leaves is not None:
            like = like_leaves[i]
            like_dtype = str(_np_dtype(like))
            like_shape = tuple(like.shape)
            if want_dtype != like_dtype or want_shape != like_shape:
                raise ValueError(
                    f"checkpoint/model mismatch at {path}: leaf {i} was "
                    f"saved as {want_dtype}{list(want_shape)} but like_tree "
                    f"expects {like_dtype}{list(like_shape)}; refusing to "
                    f"cast silently")
        out.append(arr)
    return out


def _as_tree(treedef, arrs, device) -> object:
    dev = resolve_device(device)
    return tree_unflatten(
        treedef, [torch.from_numpy(np.array(a, copy=True)).to(dev)
                  for a in arrs])


def restore(ckpt_dir: str, step: int, like_tree, device=None):
    """Restore step ``step`` into the structure of ``like_tree``, as
    tensors on ``device`` (``None``: the card; ``"cpu"``). Every leaf's
    saved dtype and shape must match ``like_tree`` exactly; mismatches
    raise ``ValueError`` instead of casting."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)
    leaves, treedef = tree_flatten(like_tree)
    return _as_tree(treedef, _load_validated(path, leaves, meta), device)


# ---------------------------------------------------------------------------
# keyed blob store (kv_* entries): the SolutionCache spill target


def _kv_path(ckpt_dir: str, key: str) -> str:
    # keys are content hashes ([0-9a-f]); reject anything that could
    # escape the directory or collide with the step_* namespace
    if not re.fullmatch(r"[A-Za-z0-9._-]+", key):
        raise ValueError(f"invalid blob key {key!r}: use [A-Za-z0-9._-]+")
    return os.path.join(ckpt_dir, f"kv_{key}")


def put(ckpt_dir: str, key: str, tree) -> str:
    """Atomically store a tree under ``key`` (overwrites). Returns path."""
    leaves, _ = tree_flatten(tree)
    return _write_entry(ckpt_dir, _kv_path(ckpt_dir, key), leaves,
                        extra_meta={"key": key})


def get(ckpt_dir: str, key: str, like_tree=None, device=None):
    """Load the tree stored under ``key``; ``None`` if absent.

    With ``like_tree`` the result takes its structure, as tensors on
    ``device`` (validated leaf by leaf like :func:`restore`); without it,
    the flat list of numpy leaves is returned and the caller re-attaches
    its own structure.
    """
    path = _kv_path(ckpt_dir, key)
    manifest = os.path.join(path, "manifest.json")
    if not os.path.exists(manifest):
        return None
    with open(manifest) as f:
        meta = json.load(f)
    if like_tree is None:
        return _load_validated(path, None, meta)
    leaves, treedef = tree_flatten(like_tree)
    return _as_tree(treedef, _load_validated(path, leaves, meta), device)
