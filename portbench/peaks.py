"""Published peak rates of the cards the benchmark runs on.

NVIDIA's data sheet for the H100 SXM (dense rates, no sparsity), at its
full power limit of 700 W; a card set below it runs slower under load,
so every run prints the limit it read beside its result. A card whose
name is not here has no peaks: roofline and peak shares are then not
reported.
"""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "fp32_ops_per_s": 67e12,      # also the 32-bit integer rate used
        "tf32_ops_per_s": 495e12,
        "bf16_ops_per_s": 989e12,
    },
}


def for_card(name: str) -> dict | None:
    """The peaks of the card called ``name``, or None."""
    return PEAKS.get(name)


def least_s(nbytes: float, nops: float, peaks: dict,
            rate: str = "fp32_ops_per_s") -> float:
    """Least time: the larger of moving ``nbytes`` at the memory rate and
    doing ``nops`` at ``rate``."""
    return max(nbytes / peaks["hbm_bytes_per_s"], nops / peaks[rate])


def kernel_roofline(run, key: str) -> float | None:
    """Percent of its roofline that kernel ``key`` of the run's kind
    reaches in the traced segment: the counted least time of its launches
    (``counts/kernels.py``; the sweeps a launch from the program's
    counters) over their device time, by kernel name in the trace."""
    k = run.kernels.get(key)
    if run.segment is None or run.peaks is None or k is None:
        return None
    n, seconds = run.segment.kernel(k["trace_name"])
    if not n or seconds <= 0:
        return None
    launches, sweeps = run.counters[key]
    per_launch = sweeps / launches if sweeps is not None and launches else 0
    return 100.0 * n * least_s(*k["count"](per_launch), run.peaks) / seconds
