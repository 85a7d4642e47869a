"""Generic STARK model interface, mirroring starky::stark::Stark.

A copy of the parts of `halo2_plonky2_verifier_tpu/models/base.py` that the
verifier calls.  `eval` is written against an abstract field-ops object `F`
(add/sub/mul/one/from_base), so one definition runs over plain ints and over
the port's extension tensors; it emits constraints into a consumer in a fixed
order, which defines the alpha folding of the vanishing polynomial.
"""

from dataclasses import dataclass
from typing import List, Tuple


@dataclass(frozen=True)
class PermutationPair:
    """starky::permutation::PermutationPair: column index pairs whose multiset
    of row-values must agree."""
    column_pairs: List[Tuple[int, int]]

    @staticmethod
    def singletons(lhs: int, rhs: int) -> "PermutationPair":
        return PermutationPair(column_pairs=[(lhs, rhs)])


class Stark:
    COLUMNS: int
    PUBLIC_INPUTS: int

    def eval(self, F, local_values, next_values, public_inputs, consumer) -> None:
        raise NotImplementedError

    def constraint_degree(self) -> int:
        raise NotImplementedError

    def permutation_pairs(self) -> List[PermutationPair]:
        return []

    # -- derived quantities (starky::stark::Stark defaults) ------------------

    def uses_permutation_args(self) -> bool:
        return bool(self.permutation_pairs())

    def quotient_degree_factor(self) -> int:
        return max(1, self.constraint_degree() - 1)

    def permutation_batch_size(self) -> int:
        return self.quotient_degree_factor()

    def num_permutation_instances(self, config) -> int:
        return len(self.permutation_pairs()) * config.num_challenges

    def num_permutation_batches(self, config) -> int:
        n = self.num_permutation_instances(config)
        b = self.permutation_batch_size()
        return (n + b - 1) // b
