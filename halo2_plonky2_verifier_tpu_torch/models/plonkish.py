"""PlonkishStark: selector-gated gate constraints plus copy constraints.

A copy of `halo2_plonky2_verifier_tpu/models/plonkish.py`: the model class
the verifier calls, and `build_mul_add_chain`, the test circuit whose
proofs the fixtures carry.

Columns: [a, b, c, q_add, q_mul, q_const, const].
Gate equation (enforced on every row; degree 3 through q_mul * a * b):
    q_add * (a + b - c) + q_mul * (a * b - c) + q_const * (const - c) = 0
Copy constraints: column pairs whose row-multisets must match (wired values),
checked by the grand-product permutation argument.
"""

from .base import PermutationPair, Stark


class PlonkishStark(Stark):
    """A fixed-size Plonkish circuit trace."""

    COLUMNS = 7
    PUBLIC_INPUTS = 1  # the output wire value of the last gate

    A, B, C, Q_ADD, Q_MUL, Q_CONST, CONST = range(7)

    def __init__(self, num_rows, copy_pairs=((0, 1),)):
        self.num_rows = num_rows
        self._copy_pairs = tuple(copy_pairs)

    def eval(self, F, local_values, next_values, public_inputs, consumer):
        a, b, c = local_values[self.A], local_values[self.B], local_values[self.C]
        q_add, q_mul = local_values[self.Q_ADD], local_values[self.Q_MUL]
        q_const, const = local_values[self.Q_CONST], local_values[self.CONST]

        add_term = F.mul(q_add, F.sub(F.add(a, b), c))
        mul_term = F.mul(q_mul, F.sub(F.mul(a, b), c))
        const_term = F.mul(q_const, F.sub(const, c))
        consumer.constraint(F.add(F.add(add_term, mul_term), const_term))
        # output exposure: last row's c equals the public input
        consumer.constraint_last_row(F.sub(c, public_inputs[0]))

    def constraint_degree(self) -> int:
        # q_mul * a * b is degree 3; quotient_degree_factor = 2,
        # permutation_batch_size = 2 (two instances per Z poly).
        return 3

    def permutation_pairs(self):
        return [PermutationPair.singletons(l, r) for (l, r) in self._copy_pairs]


def build_mul_add_chain(num_rows, x0, x1, p):
    """Test circuit: rows alternate a*b and a+b gates over a running value;
    columns A and B are copies of each other (copy constraint exercised).

    Returns (stark, trace_columns, public_inputs)."""
    rows = []
    acc = x0 % p
    for i in range(num_rows):
        a = acc
        b = acc  # A and B carry the same wire (copy constraint A ~ B)
        if i % 2 == 0:
            c = a * b % p
            q_add, q_mul, q_const, const = 0, 1, 0, 0
        else:
            c = (a + b) % p
            q_add, q_mul, q_const, const = 1, 0, 0, 0
        rows.append([a, b, c, q_add, q_mul, q_const, const])
        acc = c
    public_inputs = [rows[-1][2]]
    trace = [[rows[r][col] for r in range(num_rows)]
             for col in range(PlonkishStark.COLUMNS)]
    stark = PlonkishStark(num_rows, copy_pairs=((0, 1),))
    return stark, trace, public_inputs
