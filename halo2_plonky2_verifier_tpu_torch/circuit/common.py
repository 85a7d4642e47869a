"""A PLONK circuit's data, as the verifier reads it, and its fixture format.

`CircuitConfig`, `LutMeta`, `CommonCircuitData` (with `num_selectors`,
`num_lookup_polys`, `quotient_degree_factor`, `num_partial_products`),
`VerifierCircuitData` and `compute_circuit_digest` are copies of
`halo2_plonky2_verifier_tpu/refimpl/plonk/circuit.py:58-152`, less what
only the prover reads (`gate_instances`, `ProverCircuitData`).

The port has no circuit builder.  A circuit reaches it as a JSON fixture
(`circuit_to_json`, written by `tools/gen_torch_plonk_fixtures.py` from the
JAX package's circuit builder): the config and FRI config, `degree_bits`,
the gates in circuit order by id and parameters, `selector_groups`,
`num_gate_constraints`, `num_constants`, `k_is`, the lookup tables,
`constants_sigmas_cap`, `circuit_digest` and the number of public inputs.  `load_circuit` rebuilds
`common` and `verifier_data` from it and refuses a fixture that does not
hold together: a digest that does not recompute from the cap and
`degree_bits`, selector groups or counts that the gates do not give, or a
gate whose rebuilt id differs.  A missing gate would shift every later
vanishing term, and the quotient check would then reject valid proofs with
no other sign.

Circuit digest (the repo's convention, standing in for plonky2's):
hash_no_pad(flattened constants_sigmas cap ++ [degree_bits]).
"""

import json
from dataclasses import dataclass, field as dc_field

from ..ops import goldilocks as gl
from ..ops import poseidon
from ..utils.config import FriConfig
from .gates import compute_selector_groups, gate_from_json, gate_to_json

FORMAT = "plonk-circuit-v1"


@dataclass(frozen=True)
class CircuitConfig:
    num_wires: int = 20
    num_routed_wires: int = 16
    num_challenges: int = 2
    max_quotient_degree_factor: int = 8
    fri_config: FriConfig = dc_field(default_factory=FriConfig)


@dataclass(frozen=True)
class LutMeta:
    """Per-lookup-table metadata the vanishing terms read."""
    table: tuple            # ((inp, out), ...) canonical ints
    num_slots: int          # slots per LookupGate/LookupTableGate row
    sel_lk: int             # constants-opening index of the q_lookup column
    sel_tbl: int            # constants-opening index of the q_table column


def compute_circuit_digest(constants_sigmas_cap, degree_bits):
    """hash_no_pad(flattened cap ++ [degree_bits]) as 4 host ints (the plain
    permutation on the CPU)."""
    flat = [x for h in constants_sigmas_cap for x in h] + [degree_bits]
    out = poseidon.hash_no_pad(gl.from_u64([flat], "cpu"))
    return [int(x) for x in gl.to_u64(out)[0]]


@dataclass
class CommonCircuitData:
    """What both prover and verifier need (plonky2 CommonCircuitData)."""
    config: CircuitConfig
    degree_bits: int
    gates: list                 # gate objects, circuit order (selector order)
    selector_groups: list       # [(start, end)] ranges over `gates`
    num_gate_constraints: int
    num_constants: int          # selectors + gate constants + lookup selectors
    k_is: list
    num_public_inputs: int
    luts: list = dc_field(default_factory=list)   # LutMeta per lookup table

    @property
    def num_selectors(self):
        return len(self.selector_groups)

    @property
    def num_lookup_polys(self):
        """Lookup S polynomials committed in the zs_partial_products oracle:
        one per (challenge, lut)."""
        return self.config.num_challenges * len(self.luts)

    @property
    def quotient_degree_factor(self):
        return self.config.max_quotient_degree_factor

    @property
    def num_partial_products(self):
        r = self.config.num_routed_wires
        q = self.quotient_degree_factor
        return (r + q - 1) // q - 1

    @property
    def degree(self):
        return 1 << self.degree_bits

    def fri_params(self):
        return self.config.fri_config.fri_params(self.degree_bits)


@dataclass
class VerifierCircuitData:
    constants_sigmas_cap: list
    circuit_digest: list        # 4 Goldilocks elements


def circuit_to_json(common, verifier_data, name, num_public_inputs, **extra):
    """The fixture document of a circuit.  `common` and `verifier_data` may
    be the JAX package's objects: only their attributes are read (its
    `CommonCircuitData` has no count of public inputs, so it is passed)."""
    cfg = common.config
    fri = cfg.fri_config
    return {
        "format": FORMAT, "name": name,
        "config": {
            "num_wires": cfg.num_wires,
            "num_routed_wires": cfg.num_routed_wires,
            "num_challenges": cfg.num_challenges,
            "max_quotient_degree_factor": cfg.max_quotient_degree_factor,
            "fri_config": {
                "rate_bits": fri.rate_bits, "cap_height": fri.cap_height,
                "proof_of_work_bits": fri.proof_of_work_bits,
                "reduction_strategy": list(fri.reduction_strategy),
                "num_query_rounds": fri.num_query_rounds}},
        "degree_bits": common.degree_bits,
        "gates": [gate_to_json(g) for g in common.gates],
        "selector_groups": [list(g) for g in common.selector_groups],
        "num_gate_constraints": common.num_gate_constraints,
        "num_constants": common.num_constants,
        "k_is": [str(k) for k in common.k_is],
        "luts": [{"table": [[str(i), str(o)] for i, o in lut.table],
                  "num_slots": lut.num_slots, "sel_lk": lut.sel_lk,
                  "sel_tbl": lut.sel_tbl} for lut in common.luts],
        "constants_sigmas_cap": [[str(x) for x in h]
                                 for h in verifier_data.constants_sigmas_cap],
        "circuit_digest": [str(x) for x in verifier_data.circuit_digest],
        "num_public_inputs": num_public_inputs,
        **extra,
    }


def circuit_from_json(doc):
    """(common, verifier_data) of a fixture document; raises ValueError if
    it does not hold together (see the module docstring)."""
    if doc.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} document: {doc.get('format')!r}")
    c, f = doc["config"], doc["config"]["fri_config"]
    config = CircuitConfig(
        num_wires=c["num_wires"], num_routed_wires=c["num_routed_wires"],
        num_challenges=c["num_challenges"],
        max_quotient_degree_factor=c["max_quotient_degree_factor"],
        fri_config=FriConfig(
            rate_bits=f["rate_bits"], cap_height=f["cap_height"],
            proof_of_work_bits=f["proof_of_work_bits"],
            reduction_strategy=tuple(f["reduction_strategy"]),
            num_query_rounds=f["num_query_rounds"]))
    gates = [gate_from_json(g) for g in doc["gates"]]
    luts = [LutMeta(table=tuple((int(i), int(o)) for i, o in lut["table"]),
                    num_slots=lut["num_slots"], sel_lk=lut["sel_lk"],
                    sel_tbl=lut["sel_tbl"]) for lut in doc["luts"]]
    common = CommonCircuitData(
        config=config, degree_bits=doc["degree_bits"], gates=gates,
        selector_groups=[tuple(g) for g in doc["selector_groups"]],
        num_gate_constraints=doc["num_gate_constraints"],
        num_constants=doc["num_constants"],
        k_is=[int(k) for k in doc["k_is"]],
        num_public_inputs=doc["num_public_inputs"], luts=luts)
    cap = [[int(x) for x in h] for h in doc["constants_sigmas_cap"]]
    verifier_data = VerifierCircuitData(
        constants_sigmas_cap=cap,
        circuit_digest=[int(x) for x in doc["circuit_digest"]])
    _check(common, verifier_data)
    return common, verifier_data


def _check(common, verifier_data):
    cfg = common.config
    gates = common.gates

    def need(ok, what):
        if not ok:
            raise ValueError(f"circuit fixture: {what}")

    need([tuple(g) for g in compute_selector_groups(
        gates, cfg.max_quotient_degree_factor)] == common.selector_groups,
        "selector groups differ from the gates'")
    need(common.num_gate_constraints == max(
        (g.num_constraints() for g in gates), default=0),
        "num_gate_constraints differs from the gates'")
    need(common.num_constants == (
        common.num_selectors + max((g.num_constants for g in gates),
                                   default=0) + 2 * len(common.luts)),
        "num_constants differs from the gates' and lookups'")
    need(common.k_is == [pow(gl.GENERATOR, i, gl.P)
                         for i in range(cfg.num_routed_wires)],
         "k_is are not 7^i")
    need(len(verifier_data.constants_sigmas_cap)
         == 1 << cfg.fri_config.cap_height, "cap size")
    need(compute_circuit_digest(verifier_data.constants_sigmas_cap,
                                common.degree_bits)
         == verifier_data.circuit_digest,
         "the circuit digest does not recompute from the cap and degree_bits")


def load_circuit(path):
    """(common, verifier_data, doc) of a circuit fixture file."""
    with open(path) as f:
        doc = json.load(f)
    common, verifier_data = circuit_from_json(doc)
    return common, verifier_data, doc
