"""FibonacciStark — the toy STARK of the reference's tests and of the bench.

A copy of the verifier-side parts of
`halo2_plonky2_verifier_tpu/models/fibonacci.py`: state [x0, x1, i, j] with
transition x0' = x1, x1' = x0 + x1, i' = i + 1, j' = j + 1, and columns 2
and 3 tied by a permutation argument.
"""

from .base import PermutationPair, Stark


class FibonacciStark(Stark):
    COLUMNS = 4
    PUBLIC_INPUTS = 3
    PI_INDEX_X0 = 0
    PI_INDEX_X1 = 1
    PI_INDEX_RES = 2

    def __init__(self, num_rows: int):
        self.num_rows = num_rows

    def eval(self, F, local_values, next_values, public_inputs, consumer):
        # constraint order is part of the protocol (alpha folding)
        consumer.constraint_first_row(
            F.sub(local_values[0], public_inputs[self.PI_INDEX_X0]))
        consumer.constraint_first_row(
            F.sub(local_values[1], public_inputs[self.PI_INDEX_X1]))
        consumer.constraint_last_row(
            F.sub(local_values[1], public_inputs[self.PI_INDEX_RES]))
        consumer.constraint_transition(F.sub(next_values[0], local_values[1]))
        consumer.constraint_transition(
            F.sub(F.sub(next_values[1], local_values[0]), local_values[1]))

    def constraint_degree(self) -> int:
        return 2

    def permutation_pairs(self):
        return [PermutationPair.singletons(2, 3)]
