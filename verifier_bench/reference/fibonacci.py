"""FibonacciStark's AIR, as starky's `fibonacci_stark.rs` states it: the
state [x0, x1, i, j], x0' = x1, x1' = x0 + x1, the public inputs x0, x1 and
the result, and columns 2 and 3 tied by one permutation pair.  The
constraint order is part of the protocol (the alpha folding), so it is the
upstream one.  `eval` runs over any field-ops object with sub."""

COLUMNS = 4
PUBLIC_INPUTS = 3
CONSTRAINT_DEGREE = 2
PERMUTATION_PAIRS = [[(2, 3)]]          # one pair: column 2 against column 3


def eval(F, local_values, next_values, public_inputs, consumer):
    consumer.constraint_first_row(F.sub(local_values[0], public_inputs[0]))
    consumer.constraint_first_row(F.sub(local_values[1], public_inputs[1]))
    consumer.constraint_last_row(F.sub(local_values[1], public_inputs[2]))
    consumer.constraint_transition(F.sub(next_values[0], local_values[1]))
    consumer.constraint_transition(
        F.sub(F.sub(next_values[1], local_values[0]), local_values[1]))
