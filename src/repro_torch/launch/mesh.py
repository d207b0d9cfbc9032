"""Model meshes and device lanes for the batched solvers.

Counterpart of ``repro/launch/mesh.py``. Every factory is a function:
importing this module starts no process group.

Model meshes (``make_production_mesh``, ``make_host_mesh``): the
``("data", "model")`` meshes the models shard over
(``models.layers.Sharder``), each a ``torch.distributed``
``DeviceMesh`` over a process group. ``make_host_mesh`` spans the group
this process has started (``init_ranks``: under ``torchrun``, or
``spawn``'s ranks); ``make_production_mesh`` is the reference's 16 x 16
(2 x 16 x 16 with ``multi_pod``) on a ``fake`` process group of 256
(512) ranks, where this process is rank 0: it exists only to be
counted (the dry run builds its cells on ``meta`` and counts rank 0's
work). ``mesh_backend`` is the one place the backend is chosen: ``nccl``
where every rank has a card of its own, ``gloo`` where ranks share a
card (NCCL refuses two ranks on one device) or run on the CPU. gloo
over CUDA tensors stages them through host memory, and lacks one
collective (``models.layers.GLOO_CUDA_COMPOSED``).

Solver lanes. The reference shards a batch axis across a 1-D
``jax.sharding.Mesh`` under ``shard_map``; its solvers hold no
collectives, so each device solves its slice of the batch on its own. The port keeps exactly that and drops the
machinery: a ``SolverMesh`` is an explicit tuple of ``torch.device``s,
one per LANE, plus the name of the axis the batch splits over. A lane
solves a contiguous slice of the batch on its device; results are
concatenated back in input order on the caller's device. On one H100
``make_solver_mesh()`` is one lane; ``make_solver_mesh(n, device=...)``
puts ``n`` lanes on one named device (several lanes on the CPU in the
tests, two on the one card in the smoke).

* ``make_solver_mesh`` / ``solver_batch_axis`` / ``shard_count``: build
  and read a lane set.
* ``compact_lanes``: per-lane ``(lo, hi, device)`` slices for
  ``repro_torch.core.solver_loop.run_compacted``; compaction stays within
  each lane.
* ``scheduler_lanes``: disjoint sub-lane-sets for a dispatcher that keeps
  several batches in flight.
* ``shard_batched`` / ``dispatch_sharded``: run a batch-leading function
  lane by lane. A batch that does not divide into the lanes is padded
  with zero instances (no capacity, no weight, no edge: the inert
  instance of every built-in kind), which are dropped from the result.

Because an instance's trajectory never depends on its batch-mates, every
result equals the unsharded solve leaf for leaf.
"""
from __future__ import annotations

import functools
import os
import tempfile
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import resolve_device
from repro_torch.core.masking import tree_leaves, tree_map

__all__ = ["make_production_mesh", "make_host_mesh", "mesh_backend",
           "init_ranks", "spawn", "batch_spec", "SolverMesh",
           "make_solver_mesh", "solver_batch_axis", "shard_count",
           "compact_lanes", "scheduler_lanes", "shard_batched",
           "dispatch_sharded"]

MODEL_AXES = ("data", "model")


# ---------------------------------------------------------------------------
# Model meshes
# ---------------------------------------------------------------------------

def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 = 256 cards over ``("data", "model")``; ``multi_pod``
    prepends a 2-pod axis, ``("pod", "data", "model")``. Built on a
    ``fake`` process group in which this process is rank 0 (started here,
    or restarted where a fake group of another size is running): for
    counting only, no collective moves data."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod",) + MODEL_AXES if multi_pod else MODEL_AXES
    world = 1
    for n in shape:
        world *= n
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the production mesh is counted on a fake "
                               "process group; a real one is running")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", rank=0, world_size=world,
                                store=FakeStore())
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def mesh_backend(world: int, device) -> str:
    """``nccl`` where each of ``world`` ranks has a card of its own,
    ``gloo`` where they share a card or run on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(rank: int, world: int, device) -> torch.device:
    """The device rank ``rank`` runs on: its own card under nccl, the one
    card (``cuda:0``) where ranks share it, or the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank if mesh_backend(world, dev) == "nccl"
                        else 0)


def init_ranks(rank: int, world: int, *, store=None, device="cuda") -> str:
    """Start this process's process group as rank ``rank`` of ``world``
    (``store`` a ``torch.distributed`` store, or None for ``torchrun``'s
    environment), on ``mesh_backend``'s backend. Returns the backend."""
    backend = mesh_backend(world, device)
    dev = rank_device(rank, world, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"store": store} if store is not None else {"init_method": "env://"}
    dist.init_process_group(backend, rank=rank, world_size=world, **kw)
    return backend


def make_host_mesh(model_parallel: int = 1):
    """``(world // model_parallel, model_parallel)`` over ``("data",
    "model")`` of the process group this process has started."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"--model-parallel {model_parallel} does not divide "
                         f"the {world} ranks")
    if not dist.is_initialized():
        return None             # one process: no mesh
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (world // model_parallel, model_parallel),
                            mesh_dim_names=MODEL_AXES)


def _rank_main(rank, fn, world, store_path, device, args):
    init_ranks(rank, world, store=dist.FileStore(store_path, world),
               device=device)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args, device="cuda") -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes, each rank
    of one process group (``init_ranks``; a ``FileStore`` in a temporary
    directory, so no port is taken). Returns when all have ended; raises
    if any rank raised or died, after stopping the others."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_rank_main, args=(fn, world, os.path.join(
            d, "store"), str(device), args), nprocs=world, join=True,
            start_method="spawn")


def batch_spec(mesh, mesh_axis: str | None = None) -> tuple:
    """The spec sharding a leading batch axis over ``mesh_axis`` (default
    the mesh's first axis), trailing axes replicated: a prefix spec for
    every leaf of a batch-leading tree."""
    return (solver_batch_axis(mesh, mesh_axis),)


class SolverMesh(NamedTuple):
    """A 1-D set of solver lanes: one ``torch.device`` per lane (a device
    may carry several lanes) and the batch axis's name."""

    devices: tuple
    axis_names: tuple = ("batch",)


def make_solver_mesh(n_devices: int | None = None, *, axis: str = "batch",
                     device=None) -> SolverMesh:
    """A 1-D lane set for batch-axis sharding of the batched solvers.

    Args:
      n_devices: how many lanes. Without ``device``, one lane per CUDA
        device, the first ``n_devices`` of them (default: all); more than
        there are raises ``ValueError``, and no card raises as
        ``resolve_device`` does. With ``device``, ``n_devices`` lanes
        (default 1) all on that one device.
      axis: the axis name; the solvers' default axis is ``"batch"``.
      device: put every lane on this device (``"cpu"``, ``"cuda"``, ...).

    Returns a ``SolverMesh`` accepted by the ``mesh=`` knob of
    ``maxflow_grid_batch`` / ``solve_assignment`` / ``match_bipartite_batch``,
    of ``repro_torch.core.batch.solve_batch``, of ``solve_warm`` and of
    ``RefillSolver``.
    """
    if device is not None:
        dev = resolve_device(device)
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"n_devices={n_devices} must be >= 1")
        return SolverMesh((dev,) * n, (axis,))
    resolve_device(None)
    count = torch.cuda.device_count()
    if n_devices is not None and not 1 <= n_devices <= count:
        raise ValueError(
            f"n_devices={n_devices} outside [1, {count}] available")
    n = count if n_devices is None else int(n_devices)
    return SolverMesh(tuple(torch.device("cuda", i) for i in range(n)),
                      (axis,))


def solver_batch_axis(mesh, mesh_axis: str | None = None) -> str:
    """The axis the batch dimension shards over (default: the first), of a
    ``SolverMesh`` or a model mesh (``DeviceMesh``)."""
    names = tuple(getattr(mesh, "axis_names", None)
                  or mesh.mesh_dim_names)
    axis = mesh_axis if mesh_axis is not None else names[0]
    if axis not in names:
        raise ValueError(f"axis {axis!r} not in mesh axes {names}")
    return axis


def shard_count(mesh: SolverMesh, mesh_axis: str | None = None) -> int:
    """Number of lanes the batch axis splits into."""
    solver_batch_axis(mesh, mesh_axis)
    return len(mesh.devices)


def compact_lanes(mesh: SolverMesh, mesh_axis: str | None, batch_size: int):
    """Per-lane ``(lo, hi, device)`` slices for compacted solving.

    Early-exit compaction (``run_compacted``) under a lane set stays
    WITHIN each lane: instances never migrate between lanes, so results
    equal the unsharded and masked solves. ``batch_size`` must divide
    into the lanes (the front ends pad with inert instances first).
    """
    n = shard_count(mesh, mesh_axis)
    if batch_size % n:
        raise ValueError(
            f"batch size {batch_size} not divisible by shard count "
            f"{n}; pad the batch (repro_torch.core.batch does this "
            f"automatically)")
    per = batch_size // n
    return [(i * per, (i + 1) * per, dev)
            for i, dev in enumerate(mesh.devices)]


def scheduler_lanes(mesh: SolverMesh | None, mesh_axis: str | None = None,
                    n_lanes: int = 2):
    """Per-lane lane sets for a dispatcher with ``n_lanes`` batches in
    flight: ``None`` for each without a mesh; ``n_lanes`` contiguous
    DISJOINT sub-sets when the mesh has at least that many lanes (the
    remainder to the leading ones); the whole mesh for each otherwise.
    Which sub-set a batch lands on never changes its values."""
    if n_lanes < 1:
        raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
    if mesh is None:
        return [None] * n_lanes
    axis = solver_batch_axis(mesh, mesh_axis)
    devs = list(mesh.devices)
    if len(devs) < n_lanes:
        return [mesh] * n_lanes
    per, rem = divmod(len(devs), n_lanes)
    lanes, lo = [], 0
    for i in range(n_lanes):
        hi = lo + per + (1 if i < rem else 0)
        lanes.append(SolverMesh(tuple(devs[lo:hi]), (axis,)))
        lo = hi
    return lanes


def _batch_size(args) -> int:
    return int(tree_leaves(args)[0].shape[0])


def _pad_to_lanes(args, n_lanes: int):
    """Tensor ``args`` with zero instances appended so the batch divides
    into ``n_lanes``; returns ``(args, padded batch size)``."""
    n = _batch_size(args)
    n_pad = -n % n_lanes
    if n_pad:
        args = tree_map(lambda a: torch.cat(
            [a, a.new_zeros((n_pad,) + tuple(a.shape[1:]))]), args)
    return args, n + n_pad


def _crop_batch(tree, n: int):
    """The first ``n`` instances of every batch-leading leaf."""
    return tree_map(lambda a: a[:n], tree)


def shard_batched(fn: Callable, mesh: SolverMesh,
                  mesh_axis: str | None = None) -> Callable:
    """Wrap a batch-leading ``fn`` so the batch axis splits across lanes.

    ``fn`` takes tensor (or tree) arguments whose every leaf leads with
    the batch axis and returns a tree with the same property. The wrapper
    pads the batch with zero instances to a multiple of the lane count,
    moves each lane's contiguous slice to its device, calls ``fn`` on it,
    and concatenates the lanes' results in order on the device of the
    first argument, cropped back to the real batch.
    """
    n_lanes = shard_count(mesh, mesh_axis)

    def run(*args):
        n = _batch_size(args)
        home = tree_leaves(args)[0].device
        padded, total = _pad_to_lanes(args, n_lanes)
        per = total // n_lanes
        parts = []
        for i, dev in enumerate(mesh.devices):
            lane = tree_map(lambda a: a[i * per:(i + 1) * per].to(dev),
                            padded)
            parts.append(tree_map(lambda a: a.to(home), fn(*lane)))
        out = parts[0] if len(parts) == 1 else tree_map(
            lambda *xs: torch.cat(xs), *parts)
        return _crop_batch(out, n)

    return run


def dispatch_sharded(impl: Callable, args: tuple, batch_size: int,
                     mesh: SolverMesh, mesh_axis: str | None, *,
                     compact: bool = False, **static_kw):
    """Run batched ``impl(*args, **static_kw)`` across the lanes of
    ``mesh``: the one lane funnel the solvers' ``mesh=`` paths share.

    Masked (``compact=False``): ``shard_batched``, one ``impl`` call per
    lane. Compacted: the batch is padded to the lanes and ``impl`` runs
    once with ``compact=True`` and ``lanes=compact_lanes(...)``, so one
    host loop drives every lane's early-exit compaction. ``args`` are
    tensors in the public batch-leading layout on the caller's device;
    the result comes back there, cropped to ``batch_size``.
    """
    if _batch_size(args) != batch_size:
        raise ValueError(f"batch size {batch_size} != the arguments' "
                         f"leading {_batch_size(args)}")
    if not compact:
        return shard_batched(functools.partial(impl, **static_kw), mesh,
                             mesh_axis)(*args)
    padded, total = _pad_to_lanes(args, shard_count(mesh, mesh_axis))
    out = impl(*padded, compact=True,
               lanes=compact_lanes(mesh, mesh_axis, total), **static_kw)
    return _crop_batch(out, batch_size)
