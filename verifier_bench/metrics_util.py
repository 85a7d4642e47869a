"""What several metric readers share."""

import numpy as np


def p90_ms(run):
    """The 90th percentile of the window's batch latencies, in ms."""
    if not run.latency_s:
        return None
    return float(np.percentile(np.array(run.latency_s) * 1e3, 90))


def layer_ms(run, spans):
    """Device milliseconds a batch of the kernels launched inside any of the
    program's `spans`, or None without a trace or without such kernels."""
    tr = run.trace
    if tr is None or not tr.batches:
        return None
    us = tr.kernel_us_in(spans)
    return us / 1e3 / tr.batches if us > 0 else None
