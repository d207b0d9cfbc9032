"""Seeded dense assignment instances: integer weights drawn uniformly.

Every entry of every ``(n, n)`` matrix is uniform on the configuration's
``[w_min, w_max]``, int32, drawn on ``device`` by one ``torch.Generator``
seeded with the configuration's ``matrix_seed``, one call per batch. The
run's seed puts the matrices of each batch in an order of its own. So
every seed gets the same work in another order: a masked batch runs as
many rounds as its slowest matrix (a multiple of 16), and with the
matrices drawn from the run's seed that moved a run's rate by about 5%
from seed to seed, where two runs of one seed agreed within 1%.
"""
from __future__ import annotations

import torch


def make_pool(config: dict, traffic: dict, seed: int, device) -> list[list]:
    """``traffic["pool_batches"]`` batches of ``traffic["batch"]`` numpy
    int32 ``(n, n)`` weight matrices."""
    n = config["n"]
    lo, hi = config["w_min"], config["w_max"]
    B = traffic["batch"]
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(config["assumed"]["matrix_seed"]))
    order = torch.Generator()
    order.manual_seed(int(seed))
    pool = []
    for _ in range(traffic["pool_batches"]):
        w = torch.randint(lo, hi + 1, (B, n, n), generator=gen, device=dev,
                          dtype=torch.int32).cpu().numpy()
        pool.append([w[i] for i in torch.randperm(B, generator=order)
                     .tolist()])
    return pool
