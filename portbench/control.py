"""The control of a cell's comparison: the plain reference, computed one
precision below the configuration's, put in the program's place.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

For each seed it makes the cell's pool, draws the sample a run of that
seed would compare (every pool batch answered once), and compares the
low-precision reference's answers with the reference's, by the same
numbers and limits as a run. The grid reference runs its excess and
capacities in bfloat16 instead of float32, the assignment reference its
costs and prices in int16 instead of int32; each is stopped at twice the
rounds of the reference's longest solve. A control that passes every
limit would show the comparison blind to the drop in precision, so each
seed's line says whether it failed, as it must. The benchmark's runs do
not run it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

_HERE = pathlib.Path(__file__).resolve().parent
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == _HERE:
    sys.path.pop(0)
if str(_HERE.parent) not in sys.path:
    sys.path.insert(0, str(_HERE.parent))


class _Stub:
    """A pool batch as answered once, for drawing a run's sample."""

    def __init__(self, index: int, n: int):
        import numpy as np
        self.pool_index, self.n = index, n
        self.answers = {"rounds": np.zeros(n, np.int64)}


def readings(root, cell: str, seed: int, device) -> dict:
    """The control's numbers for ``cell`` at ``seed``, with the limits
    and whether any number is over its limit."""
    from portbench import checking, registry
    bench = registry.Bench(root)
    w = bench.cell(cell)
    config = bench.config(w["config"])
    traffic = bench.traffic(w["traffic"])
    kind = bench.part("kinds", config["kind"])
    gen = bench.part("generators", config["generator"])
    pool = gen.make_pool(config, traffic, seed, device)
    stubs = [_Stub(i, len(b)) for i, b in enumerate(pool)]
    sample = checking.draw_sample(seed, stubs, traffic["batch"], kind.SAMPLE)
    instances = [pool[ri][pos] for ri, pos in sample]
    want = kind.reference_answers(config, instances, device)
    cap = 2 * max(int(x["rounds"]) for x in want)
    got = kind.reference_answers(config, instances, device, low=True,
                                 max_rounds=cap)
    numbers, failed = checking.sampled(kind, instances, got, want, device)
    return {"cell": cell, "seed": seed, "readings": numbers,
            "limits": kind.LIMITS, "failed_instances": failed,
            "sample": len(instances),
            "control_failed": not checking.verdict(numbers, kind.LIMITS)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, three or more")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    src = _HERE.parent / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    import torch
    dev = torch.device(args.device)
    ok = True
    for s in args.seeds.split(","):
        r = readings(_HERE.parent, args.workload, int(s), dev)
        ok &= r["control_failed"]
        print(json.dumps(r), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
