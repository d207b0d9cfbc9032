"""frozen_share: percent of the instance-cycles that the masked solver
loop spends on instances that have already converged, ``1 - sum(n_live)
/ sum(gathered)`` over the window's ``CycleEvent``s."""


def read(run):
    ev = run.cycle_events
    gathered = sum(e.gathered for e in ev)
    if not gathered:
        return None
    return 100.0 * (1.0 - sum(e.n_live for e in ev) / gathered)
