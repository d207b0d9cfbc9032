"""solve_mfu: percent of the card's peak that the whole solve uses.

The counted least time of every instance answered in the window (its
inputs read once, each round's state read and written once, each global
pass once, at the card's published memory and 32-bit rates; see
``counts/solve.py``) over the window's wall. It reads the same whatever
kernels implement the work.
"""
from portbench.peaks import least_s


def read(run):
    done = run.window.done
    if not done or run.peaks is None:
        return None
    least = sum(least_s(b, o, run.peaks)
                for r in done for b, o in run.kind.work(run.config, r.answers))
    return 100.0 * least / (done[-1].t_done - run.window.t0)
