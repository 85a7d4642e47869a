"""enqueue_ms: host milliseconds from each `verify()` call to its return,
with no synchronisation, averaged over the window's batches: the entry
layer's dispatch of every launch of one verify."""


def read(run):
    if not run.enqueue_s:
        return None
    return sum(run.enqueue_s) / len(run.enqueue_s) * 1e3
