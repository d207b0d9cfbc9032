"""setup_s: seconds from the start of the process to the window: imports,
the card's context, the kernels' build when not cached, the pool of
batches made from the seed, and the warm-up solve."""


def read(run):
    return run.setup_s
