"""setup_s: seconds from the process's start to the window: imports, the
card, the kernels' build (a checkout's first run) and load, the proofs on
the card, the cycled batches, one warm verify of each."""


def read(run):
    return run.setup_s
