"""ops_per_round: device operations (kernels, copies, memsets) in the
traced segment per round of its batches, the rounds of a batch being its
longest instance's: how finely the host dispatches a round."""


def read(run):
    seg = run.segment
    if seg is None or not seg.n_ops:
        return None
    rounds = sum(int(r.answers["rounds"].max())
                 for r in run.segment_window.records)
    return seg.n_ops / rounds if rounds else None
