"""solves_per_s: instances solved to their exact optimum per second.

Every instance of the batches answered inside the window, over the time
from the window's start to the last of those answers (host clock). A
batch still in flight at the close is neither counted nor timed.
"""


def read(run):
    done = run.window.done
    if not done:
        return None
    return sum(r.n for r in done) / (done[-1].t_done - run.window.t0)
