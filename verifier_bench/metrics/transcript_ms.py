"""transcript_ms: device milliseconds a batch of the kernels launched inside the
program's `get_stark_challenges` span(s): the transcript (K2 and the challenge gathers) layer."""

from verifier_bench.metrics_util import layer_ms


def read(run):
    return layer_ms(run, ("get_stark_challenges",))
