"""fri_ms: device milliseconds a batch of the kernels launched inside the
program's `subgroup_x`, `combine_initial`, `compute_evaluation` and
`final_poly_eval` spans: FRI's arithmetic."""

from verifier_bench.metrics_util import layer_ms

SPANS = ("subgroup_x", "combine_initial", "compute_evaluation",
         "final_poly_eval")


def read(run):
    return layer_ms(run, SPANS)
