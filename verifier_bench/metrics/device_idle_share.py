"""device_idle_share: the percent of the traced window's wall in which no
operation ran on the card: 1 - (the union of the device intervals) / (the
window)."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    span = tr.window[1] - tr.window[0]
    return 100.0 * (1.0 - tr.busy_us() / span) if span > 0 else None
