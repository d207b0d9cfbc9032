"""Which ``_c10d_functional`` collectives gloo carries for CUDA tensors,
with ranks that share one card, and how long an all-reduce of 18.9 MB
(smollm's 8 x 1024 x 576 float32 activations) takes over 3 of them.

    python3 tests/torch_mesh_gloo_probe.py

Each collective runs in fresh processes (2 ranks, spawned): a collective
that kills a rank shows as a spawn error and leaves the next ones to
run. Prints one line per collective with each rank's result: its
values, or the error it raised. Needs a card; imports no jax.
"""
import json
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

F = torch.ops._c10d_functional
# the functional collectives, the process group's own all-gather and
# reduce-scatter, and the timed all-reduce
OPS = ["all_reduce", "all_reduce_max", "all_gather", "reduce_scatter",
       "all_to_all", "broadcast", "pg_allgather_into", "pg_reduce_scatter",
       "big"]


def collective(op: str, t: torch.Tensor, world: int, name: str):
    if op == "all_reduce":
        return F.wait_tensor(F.all_reduce(t, "sum", name))
    if op == "all_reduce_max":
        return F.wait_tensor(F.all_reduce(t, "max", name))
    if op == "all_gather":
        return F.wait_tensor(F.all_gather_into_tensor(t, world, name))
    if op == "reduce_scatter":
        return F.wait_tensor(F.reduce_scatter_tensor(
            torch.cat([t] * world), "sum", world, name))
    if op == "all_to_all":
        return F.wait_tensor(F.all_to_all_single(
            torch.cat([t] * world), [4] * world, [4] * world, name))
    if op == "broadcast":
        return F.wait_tensor(F.broadcast(t, 0, name))
    o = torch.empty(4 * world if op == "pg_allgather_into" else 4,
                    device="cuda")
    if op == "pg_allgather_into":
        dist.all_gather_into_tensor(o, t)
    else:
        dist.reduce_scatter_tensor(o, torch.cat([t] * world))
    return o


def run(rank: int, world: int, path: str, op: str, out: str) -> None:
    torch.cuda.set_device(0)
    res = {"rank": rank, "op": op}
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(path, world))
    name = dist.group.WORLD.group_name
    t = torch.arange(4., device="cuda") + rank
    try:
        if op == "big":
            big = torch.randn(8 * 1024 * 576, device="cuda")
            for _ in range(2):          # the second round is timed
                torch.cuda.synchronize()
                t0 = time.time()
                for _ in range(10):
                    F.wait_tensor(F.all_reduce(big, "sum", name))
                torch.cuda.synchronize()
            res["ms_per_all_reduce"] = (time.time() - t0) * 100
        else:
            o = collective(op, t, world, name)
            torch.cuda.synchronize()
            res["values"] = [o.device.type, o.tolist()[:8]]
    except Exception as e:          # reported, not raised: the next op runs
        res["error"] = f"{type(e).__name__}: {str(e)[:200]}"
    with open(f"{out}.{rank}", "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    print(torch.__version__, torch.cuda.get_device_name(0), flush=True)
    for op in OPS:
        world = 3 if op == "big" else 2
        d = tempfile.mkdtemp()
        t0 = time.time()
        try:
            mp.start_processes(run, args=(world, os.path.join(d, "store"), op,
                                          os.path.join(d, "out")),
                               nprocs=world, start_method="spawn")
            status = "ok"
        except Exception as e:
            status = f"a rank died: {type(e).__name__} {str(e)[:120]}"
        got = [open(os.path.join(d, f"out.{r}")).read()
               if os.path.exists(os.path.join(d, f"out.{r}")) else None
               for r in range(world)]
        print(op, status, f"{time.time() - t0:.1f}s", got, flush=True)
