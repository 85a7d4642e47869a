"""A proof's geometry, from a configuration file's numbers and its stark.

starky's derived quantities (`Stark` defaults: quotient degree factor,
permutation batches) and plonky2's FRI parameters
(`FriReductionStrategy::ConstantArityBits`): everything the reference, the
traffic and the work counts need to know about the arrays of one proof.
"""

import importlib
from dataclasses import dataclass


@dataclass(frozen=True)
class Geometry:
    stark: str
    num_rows: int
    degree_bits: int
    columns: int
    public_inputs: int
    num_zs: int
    num_quotient: int
    num_challenges: int
    num_challenge_sets: int
    cap_height: int
    rate_bits: int
    proof_of_work_bits: int
    num_queries: int
    reduction_arity_bits: tuple
    hasher: str
    transcript: str

    @property
    def lde_bits(self):
        return self.degree_bits + self.rate_bits

    @property
    def cap_size(self):
        return 1 << self.cap_height

    @property
    def initial_depth(self):
        return self.lde_bits - self.cap_height

    @property
    def step_depths(self):
        out, bits = [], self.initial_depth
        for ab in self.reduction_arity_bits:
            bits -= ab
            out.append(bits)
        return tuple(out)

    @property
    def final_poly_len(self):
        return 1 << (self.degree_bits - sum(self.reduction_arity_bits))

    @property
    def oracle_widths(self):
        return (self.columns, self.num_zs, self.num_quotient)

    def field_shapes(self):
        """field -> one proof's array shape (a list for a list field)."""
        cap, q = (self.cap_size, 4), self.num_queries
        zs = (self.num_zs, 2)
        return {
            "trace_cap": cap, "zs_cap": cap, "quotient_cap": cap,
            "local_values": (self.columns, 2),
            "next_values": (self.columns, 2),
            "permutation_zs": zs, "permutation_zs_next": zs,
            "quotient_polys": (self.num_quotient, 2),
            "commit_caps": [cap] * len(self.reduction_arity_bits),
            "final_poly": (self.final_poly_len, 2), "pow_witness": (),
            "initial_evals": [(q, w) for w in self.oracle_widths],
            "initial_siblings": [(q, self.initial_depth, 4)] * 3,
            "step_evals": [(q, 1 << ab, 2) for ab in self.reduction_arity_bits],
            "step_siblings": [(q, d, 4) for d in self.step_depths],
            "public_inputs": (self.public_inputs,),
        }


def stark_model(name):
    """The reference's AIR module of a stark family (`reference/<name>.py`)."""
    return importlib.import_module(f"{__package__}.{name}")


def reduction_arity_bits(degree_bits, rate_bits, cap_height, arity_bits,
                         final_poly_bits):
    """plonky2 ConstantArityBits: fold by 2^arity_bits while the degree
    exceeds the final polynomial's and the folded tree stays at least
    cap_height deep."""
    out, db = [], degree_bits
    while db > final_poly_bits and db + rate_bits - arity_bits >= cap_height:
        out.append(arity_bits)
        db -= arity_bits
    return tuple(out)


def geometry(config, num_rows):
    """The Geometry of proofs of `num_rows` rows under a configuration
    file's dict."""
    model = stark_model(config["stark"])
    sc = config["starky_config"]
    degree_bits = num_rows.bit_length() - 1
    if 1 << degree_bits != num_rows:
        raise ValueError(f"{num_rows} rows is not a power of two")
    factor = max(1, model.CONSTRAINT_DEGREE - 1)
    pairs = len(model.PERMUTATION_PAIRS)
    arity, final_bits = sc["reduction_strategy"]
    return Geometry(
        stark=config["stark"], num_rows=num_rows, degree_bits=degree_bits,
        columns=model.COLUMNS, public_inputs=model.PUBLIC_INPUTS,
        num_zs=-(-pairs * sc["num_challenges"] // factor),
        num_quotient=factor * sc["num_challenges"],
        num_challenges=sc["num_challenges"], num_challenge_sets=factor,
        cap_height=sc["cap_height"], rate_bits=sc["rate_bits"],
        proof_of_work_bits=sc["proof_of_work_bits"],
        num_queries=sc["num_query_rounds"],
        reduction_arity_bits=reduction_arity_bits(
            degree_bits, sc["rate_bits"], sc["cap_height"], arity,
            final_bits),
        hasher=config["hasher"], transcript=config["transcript"])
