"""launches_per_batch: device kernels launched inside the traced
`verify()` calls, over the traced batches."""

from verifier_bench.harness import BATCH_SPAN


def read(run):
    tr = run.trace
    if tr is None or not tr.batches:
        return None
    return int(tr.kernels_in([BATCH_SPAN]).sum()) / tr.batches
