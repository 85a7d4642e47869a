"""proofs_per_s: every lane whose verdict reached the host in the window,
valid or tampered, over the window's seconds (host clock)."""


def read(run):
    return run.lanes / run.window_s if run.window_s > 0 else None
