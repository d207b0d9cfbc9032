"""The benchmark's side of the ``"assignment"`` kind: dense weight
matrices (see ``kinds/maxflow.py`` for what a kind module provides)."""
from __future__ import annotations

import numpy as np
import torch

from portbench.counts import kernels as kc
from portbench.counts import solve as sc
from portbench.reference import assignment_auction as ref

SAMPLE = 8

# Every number compared is exact: the configuration promises a perfect
# matching of maximum weight, and the reference follows the same integer
# trajectory (limit 0).
LIMITS = {
    "weight_diff": 0,   # sampled instances whose weight (as reported, or
    #                     of the reported matching) is not the optimum
    "match_diff": 0,    # rows of sampled instances on another column
    "rounds_diff": 0,   # sampled instances whose rounds differ
    "not_perm": 0,      # sampled matchings that are not permutations
    "not_optimal": 0,   # sampled matchings with a gainful reassignment
}


def answers(results: list) -> dict:
    """The batch's answers on the host: each row's column, the weight,
    rounds and convergence of each instance, in request order."""
    def host(vals):
        return torch.stack(list(vals)).cpu().numpy()
    return {
        "col_of_row": host(r.col_of_row for r in results).astype(np.int64),
        "weight": host(r.weight for r in results).astype(np.int64),
        "rounds": host(r.rounds for r in results).astype(np.int64),
        "converged": host(r.converged for r in results),
    }


def one(ans: dict, i: int) -> dict:
    return {k: v[i] for k, v in ans.items()}


def _auction(config: dict, dtype) -> ref.Auction:
    s = config["solver"]
    return ref.Auction(alpha=s["alpha"],
                       rounds_per_heuristic=s["rounds_per_heuristic"],
                       max_rounds=s["max_rounds"], dtype=dtype)


def reference_answers(config: dict, instances: list, device, *,
                      low: bool = False, max_rounds: int | None = None
                      ) -> list[dict]:
    """The reference's answers for ``instances``; ``low`` runs it in
    int16 (the control), stopped after ``max_rounds`` rounds."""
    w = torch.tensor(np.stack(instances), device=device)
    rph = config["solver"]["rounds_per_heuristic"]
    solver = _auction(config, torch.int16 if low else torch.int32)
    a = solver.solve(w, cycle_budget=None if max_rounds is None
                     else -(-max_rounds // rph))
    ans = {"col_of_row": a.col_of_row.cpu().numpy().astype(np.int64),
           "weight": a.weight.cpu().numpy().astype(np.int64),
           "rounds": a.rounds.cpu().numpy().astype(np.int64),
           "converged": a.converged.cpu().numpy()}
    return [one(ans, i) for i in range(len(instances))]


def compare(instances: list, got: list[dict], want: list[dict],
            device) -> dict:
    """The numbers of ``LIMITS`` for answers ``got`` against ``want``;
    ``not_perm`` and ``not_optimal`` judge ``got`` on the weights alone."""
    w = torch.tensor(np.stack(instances), device=device)
    n = w.shape[-1]
    col = torch.tensor(np.stack([g["col_of_row"] for g in got]),
                       device=device)
    of_matching = ref.matching_weight(w, col).cpu().numpy()
    perm = ref.is_permutation(col, n)
    best = ref.optimal(w, col) & perm
    return {
        "weight_diff": sum(int(g["weight"]) != int(x["weight"])
                           or int(m) != int(x["weight"])
                           for g, x, m in zip(got, want, of_matching)),
        "match_diff": int(sum(np.count_nonzero(g["col_of_row"]
                                               != x["col_of_row"])
                              for g, x in zip(got, want))),
        "rounds_diff": sum(int(g["rounds"]) != int(x["rounds"])
                           for g, x in zip(got, want)),
        "not_perm": int((~perm).sum()),
        "not_optimal": int((~best).sum()),
    }



def work(config: dict, ans: dict) -> list[tuple[float, float]]:
    rph = config["solver"]["rounds_per_heuristic"]
    return [sc.assignment_instance(config["n"], int(r), rph)
            for r in ans["rounds"]]


def kernels(config: dict, batch: int) -> dict:
    from repro_torch.kernels.bidding.kernel import bidding
    n = config["n"]
    return {
        "K4": {"trace_name": "bidding_kernel",
               "counter": lambda: (bidding.launches, None),
               "count": lambda per_launch: kc.k4(batch, n)},
    }
