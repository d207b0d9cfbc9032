"""idle_share: percent of the traced segment's wall in which no operation
ran on the card, both from the same profiler trace."""


def read(run):
    seg = run.segment
    if seg is None or not seg.n_ops or seg.window_s <= 0:
        return None
    return 100.0 * (1.0 - seg.busy_s / seg.window_s)
