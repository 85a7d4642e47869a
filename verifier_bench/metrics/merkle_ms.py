"""merkle_ms: device milliseconds a batch of the kernels launched inside the
program's `verify_merkle_proofs` span(s): the Merkle (leaf hashes, paths, cap compare) layer."""

from verifier_bench.metrics_util import layer_ms


def read(run):
    return layer_ms(run, ("verify_merkle_proofs",))
