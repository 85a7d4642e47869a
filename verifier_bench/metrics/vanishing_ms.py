"""vanishing_ms: device milliseconds a batch of the kernels launched inside the
program's `vanishing_poly_check` span(s): the vanishing-check layer."""

from verifier_bench.metrics_util import layer_ms


def read(run):
    return layer_ms(run, ("vanishing_poly_check",))
