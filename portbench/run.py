"""Runs one cell of the benchmark of ``repro_torch`` once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Set-up makes the cell's pool of batches from
the seed on the card and warms up every shape the window uses; the window
then serves the cell's traffic for ``--seconds``. With ``--trace 0`` the
last line of standard output is the result with the cell's end-to-end
metrics; with ``--trace 1`` the same window carries the cycle telemetry
and is followed by a profiled segment, and the result holds the per-layer
metrics. Either way the answers are compared with the plain reference
after the window, and each number compared is printed beside its limit,
last on standard error and last in the result.

Exits non-zero, printing no result, without the cards the cell asks for,
without the program's sources (``src/repro_torch``), or when the process
holds JAX, the JAX package or its benchmark once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
from typing import NamedTuple  # noqa: E402

_HERE = pathlib.Path(__file__).resolve().parent
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == _HERE:
    sys.path.pop(0)                 # run as a script: no shadowed modules
if str(_HERE.parent) not in sys.path:
    sys.path.insert(0, str(_HERE.parent))


class BatchRecord(NamedTuple):
    pool_index: int
    n: int
    t_start: float
    t_prepared: float
    t_done: float
    answers: dict


class Server:
    """The timed path of one cell: the program's batch front end on numpy
    instances, as ``solve_batch`` drives it, answers brought to the host."""

    def __init__(self, batch_mod, kind, config, pool, device, spans=False):
        self.batch_mod, self.kind, self.config = batch_mod, kind, config
        self.pool, self.device, self.spans = pool, device, spans
        self.pool_size = len(pool)
        self.solver_kw = dict(config["solver"])

    def solve(self, index: int, **override) -> BatchRecord:
        from portbench.profiling import span
        payloads = self.pool[index]
        drv = self.config["driver"]
        t0 = time.perf_counter()
        with span("portbench.prepare", self.spans):
            preps = self.batch_mod.prepare_buckets(
                self.config["kind"], payloads, bucket=drv["bucket"])
        t1 = time.perf_counter()
        results = {}
        with span("portbench.solve", self.spans):
            for prep in preps:
                out, _ = self.batch_mod.solve_prepared(
                    prep, compact=drv["compact"], device=self.device,
                    **{**self.solver_kw, **override})
                results.update(out)
        with span("portbench.answers", self.spans):
            ans = self.kind.answers([results[i]
                                     for i in range(len(payloads))])
        del results
        return BatchRecord(index, len(payloads), t0, t1,
                           time.perf_counter(), ans)


class Run:
    """What a metric's reader reads: the cell, the set-up time, the
    window's batches and telemetry, and the traced segment."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _counters(kernels: dict) -> dict:
    return {k: v["counter"]() for k, v in kernels.items()}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, root=None, device=None, out=None) -> int:
    """Run a cell. ``device="cpu"`` (tests only) runs the plain versions
    without looking for a card; ``out`` receives the result line."""
    args = parse(argv)
    root = pathlib.Path(root or _HERE.parent)
    from portbench import registry
    bench = registry.Bench(root)
    cell = bench.cell(args.workload)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    cache = root / "build" / "portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    import torch

    from portbench import cardinfo, checking, peaks, profiling
    if device is None:
        cardinfo.require_cards(cell["chips"])
    src = root / "src"
    if not (src / "repro_torch").is_dir():
        sys.exit(f"portbench: no program sources at {src / 'repro_torch'}")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    import repro_torch.core.batch as batch_mod

    dev = torch.device(device or "cuda")
    torch.set_num_threads(1)
    kind = bench.part("kinds", config["kind"])
    loop = bench.part("loops", traffic["loop"])
    gen = bench.part("generators", config["generator"])
    trace = bool(args.trace)

    # ---- set-up: the pool from the seed, every shape warmed up
    pool = gen.make_pool(config, traffic, args.seed, dev)
    server = Server(batch_mod, kind, config, pool, dev)
    server.solve(0, max_rounds=config["solver"]["rounds_per_heuristic"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - T_START

    # ---- the window
    events = []
    if trace:
        from repro_torch.core.solver_loop import cycle_events
        with cycle_events(events.append, masked=True):
            window = loop.run(server, seconds=args.seconds)
    else:
        window = loop.run(server, seconds=args.seconds)
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)

    segment = seg_window = None
    counters = {}
    kernels = kind.kernels(config, traffic["batch"])
    notes = ["batches " + " ".join(
        f"{r.pool_index}:{r.t_done - r.t_start:.3f}" for r in window.records)]
    if trace:
        server.spans = True
        before = _counters(kernels)
        t = time.perf_counter()
        seg_window, segment = profiling.traced(
            lambda: loop.run(server, batches=traffic["trace_batches"],
                             start=window.next_index), dev)
        after = _counters(kernels)
        plain = {r.pool_index: r.t_done - r.t_start for r in window.records}
        same = [plain.get(r.pool_index) for r in seg_window.records]
        notes.append(f"traced segment {segment.window_s:.3f} s, the same "
                     f"batches unprofiled "
                     f"{sum(same) if None not in same else 'not run'} s, "
                     f"trace read in {time.perf_counter() - t:.1f} s")
        counters = {k: tuple(None if a is None else a - b
                             for a, b in zip(after[k], before[k]))
                    for k in kernels}
        server.spans = False
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- correct: the answers against the plain reference
    records = window.records
    readings = checking.whole_run(records)
    limits = dict(checking.GLOBAL_LIMITS)
    sample = checking.draw_sample(args.seed, records, traffic["batch"],
                                  kind.SAMPLE)
    instances = [pool[records[ri].pool_index][pos] for ri, pos in sample]
    got = [kind.one(records[ri].answers, pos) for ri, pos in sample]
    t = time.perf_counter()
    want = kind.reference_answers(config, instances, dev)
    notes.append(f"reference {time.perf_counter() - t:.1f} s")
    per, failed_sample = checking.sampled(kind, instances, got, want, dev)
    readings.update(per)
    limits.update(kind.LIMITS)
    correct = checking.verdict(readings, limits)
    failed = readings["unconverged"] + readings["repeat_diff"] + failed_sample

    bad = cardinfo.forbidden_modules()
    if bad:
        sys.exit("portbench: the process holds " + ", ".join(bad))

    # ---- the metrics (every end-to-end one must read; a per-layer one
    # with nothing to read is left out)
    missing = []
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    run = Run(cell=cell, config=config, traffic=traffic, kind=kind,
              setup_s=setup_s, window=window, cycle_events=events,
              segment=segment, segment_window=seg_window, counters=counters,
              kernels=kernels, peaks=peaks.for_card(name), device=dev)
    metrics = {}
    for m in bench.metrics(cell["name"], trace):
        value = bench.part("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        elif not trace:
            missing.append(m["name"])
    if missing:
        sys.exit("portbench: no reading of " + ", ".join(missing))

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": name, "count": cell["chips"],
                   "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct),
              "attempted": int(sum(r.n for r in records)),
              "failed": int(failed), "metrics": metrics,
              "device": device_info}
    if segment is not None:
        device_info["busy_s"] = segment.busy_s
        device_info["window_s"] = segment.window_s
        result["breakdown"] = {"device_ops": segment.top_ops(),
                               "idle_gaps": segment.idle_by_host}
    result["checks"] = {k: {"value": readings[k], "limit": limits[k]}
                       for k in limits}
    print(f"portbench: {cell['name']} seed {args.seed}: card "
          f"{cardinfo.power_limit() if dev.type == 'cuda' else 'cpu'}; "
          f"{len(window.done)} batches in {args.seconds} s; sample "
          f"{len(sample)}; " + "; ".join(notes), file=out or sys.stdout)
    for k in limits:
        print(f"check {k} {readings[k]} limit {limits[k]}", file=sys.stderr)
    print(json.dumps(result), file=out or sys.stdout, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
