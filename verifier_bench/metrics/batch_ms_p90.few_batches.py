"""batch_ms_p90.few_batches: the 90th percentile, over every batch of the
window, of the milliseconds from the `verify()` call to its verdicts on
the host; per-layer, since no window holds the 100 batches an end-to-end
tail would want."""

from verifier_bench.metrics_util import p90_ms


def read(run):
    return p90_ms(run)
