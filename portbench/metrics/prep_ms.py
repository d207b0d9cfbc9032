"""prep_ms: host milliseconds per batch of the front end's host stage
(``prepare_buckets``: stacking and padding), from the benchmark's own
span around the call, averaged over the window's batches."""


def read(run):
    recs = run.window.done
    if not recs:
        return None
    return 1e3 * sum(r.t_prepared - r.t_start for r in recs) / len(recs)
