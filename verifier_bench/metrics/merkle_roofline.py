"""merkle_roofline: the least time an H100 could take for a batch's Merkle
work (`work.merkle_work`: active compressions and sponge permutations in
their cheapest form, leaves, siblings and caps read once) as a percent of
`merkle_ms`, the device time inside `verify_merkle_proofs`."""

from verifier_bench import work
from verifier_bench.metrics_util import layer_ms


def read(run):
    ms = layer_ms(run, ("verify_merkle_proofs",))
    if ms is None:
        return None
    w, b = work.merkle_work(run.geom), run.traffic["batch"]
    return 100.0 * work.least_seconds(w["bytes"] * b, w["ops"] * b) / (ms / 1e3)
