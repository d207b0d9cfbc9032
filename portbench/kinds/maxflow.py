"""The benchmark's side of the ``"maxflow"`` kind: grid-cut instances.

What the harness needs of a solver kind: the answers a solve returns,
brought to the host as a user receives them; the comparison of answers
with the plain reference; the counted work of each instance; the
kernels whose roofline share the trace can give.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.counts import kernels as kc
from portbench.counts import solve as sc
from portbench.reference import grid_maxflow as ref

SAMPLE = 8    # instances compared with the reference each run, and the
#               one with the most rounds

# Every number compared is exact: the configuration promises the exact
# maximum flow and a minimum cut, and the reference follows the same
# integer-exact trajectory, so any difference is a fault (limit 0).
LIMITS = {
    "flow_diff": 0,    # sampled instances whose flow is not the reference's
    "cut_diff": 0,     # pixels of sampled cuts on the other side
    "rounds_diff": 0,  # sampled instances whose rounds differ
    "heur_diff": 0,    # sampled instances whose global relabels differ
    "cut_gap": 0,      # sum over the sample of |flow - capacity of its cut|
}


def answers(results: list) -> dict:
    """The batch's answers on the host: flow, cut, rounds, global
    relabels and convergence of each instance, in request order."""
    def host(vals, dtype=None):
        t = torch.stack(list(vals))
        return t.cpu().numpy() if dtype is None else t.cpu().numpy().astype(
            dtype)
    return {
        "flow": host(r.flow for r in results),
        "cut": host(r.cut for r in results),
        "rounds": host((r.rounds for r in results), np.int64),
        "heuristics": host((r.heuristics for r in results), np.int64),
        "converged": host(r.converged for r in results),
    }


def one(ans: dict, i: int) -> dict:
    """Instance ``i`` of a batch's answers."""
    return {k: v[i] for k, v in ans.items()}


def _stack(instances, device):
    return tuple(torch.tensor(np.stack([p[k] for p in instances]),
                              device=device) for k in range(3))


def reference_answers(config: dict, instances: list, device, *,
                      low: bool = False, max_rounds: int | None = None
                      ) -> list[dict]:
    """The reference's answers for ``instances``; ``low`` runs it with
    the excess and capacities in bfloat16 (the control), capped at
    ``max_rounds``."""
    cap, cs, ct = _stack(instances, device)
    s = config["solver"]
    a = ref.solve(cap, cs, ct, rounds_per_heuristic=s["rounds_per_heuristic"],
                  max_rounds=max_rounds or s["max_rounds"],
                  dtype=torch.bfloat16 if low else torch.float32)
    ans = {"flow": a.flow.float().cpu().numpy(), "cut": a.cut.cpu().numpy(),
           "rounds": a.rounds.cpu().numpy().astype(np.int64),
           "heuristics": a.heuristics.cpu().numpy().astype(np.int64),
           "converged": a.converged.cpu().numpy()}
    return [one(ans, i) for i in range(len(instances))]


def compare(instances: list, got: list[dict], want: list[dict],
            device) -> dict:
    """The numbers of ``LIMITS`` for answers ``got`` against ``want``;
    ``cut_gap`` certifies ``got`` alone: a flow equal to the capacity of
    a cut is the maximum."""
    cap, cs, ct = _stack(instances, device)
    cuts = torch.tensor(np.stack([g["cut"] for g in got]), device=device)
    cut_cap = ref.cut_capacity(cap, cs, ct, cuts).cpu().numpy()
    flows = np.array([float(g["flow"]) for g in got])
    return {
        "flow_diff": sum(float(g["flow"]) != float(w["flow"])
                         for g, w in zip(got, want)),
        "cut_diff": int(sum(np.count_nonzero(g["cut"] != w["cut"])
                            for g, w in zip(got, want))),
        "rounds_diff": sum(int(g["rounds"]) != int(w["rounds"])
                           for g, w in zip(got, want)),
        "heur_diff": sum(int(g["heuristics"]) != int(w["heuristics"])
                         for g, w in zip(got, want)),
        "cut_gap": float(np.abs(flows - cut_cap).sum()),
    }



def work(config: dict, ans: dict) -> list[tuple[float, float]]:
    """Counted (bytes, operations) of each instance of a batch."""
    H, W = config["height"], config["width"]
    return [sc.grid_instance(H, W, int(r), int(h))
            for r, h in zip(ans["rounds"], ans["heuristics"])]


def kernels(config: dict, batch: int) -> dict:
    """The kernels of this kind's timed path: the name their launches
    carry in a device trace, the program's launch counter and the counted
    (bytes, operations) of one launch given the sweeps per launch."""
    from repro_torch.kernels.bfs_relabel.kernel import bfs_relabel_sweeps
    from repro_torch.kernels.grid_push.kernel import grid_push_decide
    nodes = batch * config["height"] * config["width"]
    return {
        "K1": {"trace_name": "grid_push_decide_kernel",
               "counter": lambda: (grid_push_decide.launches, None),
               "count": lambda per_launch: kc.k1(nodes)},
        "K3": {"trace_name": "bfs_relabel_sweep_tiles",
               "counter": lambda: (bfs_relabel_sweeps.launches,
                                   bfs_relabel_sweeps.sweeps),
               "count": lambda per_launch: kc.k3(nodes, per_launch)},
    }
