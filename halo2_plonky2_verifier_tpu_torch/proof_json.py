"""Proof containers, and the readers and writers of the repo's own proof
JSON.

Copies of the dataclasses of `halo2_plonky2_verifier_tpu/refimpl/proof.py:
18-87` (starky proofs, the FRI opening proof) and
`halo2_plonky2_verifier_tpu/refimpl/plonk/proof.py:11-56` (plonky2 PLONK
proofs), of their readers: `fri_proof_from_json_dict` (refimpl
proof.py:122), `proof_from_json` (:190) and `plonk_proof_from_json` (plonk
proof.py:78), and of their writers: `ext_to_json` (proof.py:94
`_ext_to_json`), `proof_to_json_dict_fri` (:98), `proof_to_json` (:148) and
`plonk_proof_to_json` (plonk proof.py:58).  These are the formats of the
`tests/fixtures/*.json` and `*.jsonl` files.  A writer gives the string the
JAX package's writer gives for the same proof, key order, numbers and
decimal strings (a PLONK proof's caps and public inputs) and nulls alike.

Every field element is read as a Python int, whether the file holds it as a
JSON number or as a decimal string (the PLONK files write caps and public
inputs as strings).  A Goldilocks hash is a list of 4 ints; a BN254 hash is
one int below 2^256.  Values are not range-checked here: the verifiers'
canonicality verdicts reject a non-canonical value lane by lane.
"""

import json
from dataclasses import dataclass
from typing import List, Optional, Tuple

Ext = Tuple[int, int]


@dataclass
class MerkleProof:
    siblings: list


@dataclass
class FriInitialTreeProof:
    # per oracle: (evals at the queried point, merkle proof)
    evals_proofs: List[Tuple[List[int], MerkleProof]]


@dataclass
class FriQueryStep:
    evals: List[Ext]
    merkle_proof: MerkleProof


@dataclass
class FriQueryRound:
    initial_trees_proof: FriInitialTreeProof
    steps: List[FriQueryStep]


@dataclass
class FriProof:
    commit_phase_merkle_caps: list
    query_round_proofs: List[FriQueryRound]
    final_poly: List[Ext]
    pow_witness: int


@dataclass
class StarkOpeningSet:
    local_values: List[Ext]
    next_values: List[Ext]
    permutation_zs: Optional[List[Ext]]
    permutation_zs_next: Optional[List[Ext]]
    quotient_polys: List[Ext]


@dataclass
class StarkProof:
    trace_cap: list
    permutation_zs_cap: Optional[list]
    quotient_polys_cap: list
    openings: StarkOpeningSet
    opening_proof: FriProof

    def recover_degree_bits(self, config) -> int:
        """The trace's degree bits from the first initial Merkle proof's
        depth (a copy of `refimpl/proof.py:77-81`; reference:
        verifier/src/stark/mod.rs:82-89)."""
        initial_merkle_proof = (self.opening_proof.query_round_proofs[0]
                                .initial_trees_proof.evals_proofs[0][1])
        lde_bits = (config.fri_config.cap_height
                    + len(initial_merkle_proof.siblings))
        return lde_bits - config.fri_config.rate_bits


@dataclass
class StarkProofWithPublicInputs:
    proof: StarkProof
    public_inputs: List[int]


PLONK_OPENING_FIELDS = ("constants", "plonk_sigmas", "wires", "plonk_zs",
                        "plonk_zs_next", "partial_products", "quotient_polys",
                        "lookup_zs", "lookup_zs_next")


@dataclass
class PlonkOpeningSet:
    """plonky2 OpeningSet: evaluations at zeta (and zeta*g for the Zs);
    lookup_zs / lookup_zs_next are empty for a circuit without lookups."""
    constants: List[Ext]
    plonk_sigmas: List[Ext]
    wires: List[Ext]
    plonk_zs: List[Ext]
    plonk_zs_next: List[Ext]
    partial_products: List[Ext]
    quotient_polys: List[Ext]
    lookup_zs: List[Ext]
    lookup_zs_next: List[Ext]


@dataclass
class PlonkProof:
    wires_cap: list
    plonk_zs_partial_products_cap: list
    quotient_polys_cap: list
    openings: PlonkOpeningSet
    opening_proof: FriProof


@dataclass
class PlonkProofWithPublicInputs:
    proof: PlonkProof
    public_inputs: List[int]


# ----------------------------------------------------------------------------
# readers
# ----------------------------------------------------------------------------

def hash_from_json(h):
    """A Goldilocks hash (a list of 4) or a BN254 hash (one int)."""
    if isinstance(h, list):
        return [int(x) for x in h]
    return int(h)


def cap_from_json(v):
    return [hash_from_json(h) for h in v]


def ext_from_json(e):
    if len(e) != 2:
        raise ValueError(f"an extension element has 2 coordinates, got "
                         f"{len(e)}")
    return (int(e[0]), int(e[1]))


def exts_from_json(v):
    return None if v is None else [ext_from_json(e) for e in v]


def fri_proof_from_json_dict(op: dict) -> FriProof:
    return FriProof(
        commit_phase_merkle_caps=[cap_from_json(c) for c in
                                  op["commit_phase_merkle_caps"]],
        query_round_proofs=[
            FriQueryRound(
                initial_trees_proof=FriInitialTreeProof(evals_proofs=[
                    ([int(x) for x in ep["evals"]],
                     MerkleProof(siblings=cap_from_json(ep["siblings"])))
                    for ep in qr["initial_trees_proof"]]),
                steps=[
                    FriQueryStep(
                        evals=exts_from_json(st["evals"]),
                        merkle_proof=MerkleProof(
                            siblings=cap_from_json(st["siblings"])))
                    for st in qr["steps"]],
            )
            for qr in op["query_round_proofs"]],
        final_poly=exts_from_json(op["final_poly"]),
        pow_witness=int(op["pow_witness"]),
    )


def _doc(s):
    return json.loads(s) if isinstance(s, (str, bytes)) else s


def proof_from_json(s) -> StarkProofWithPublicInputs:
    """A starky proof from the repo's JSON (a string or its parsed dict)."""
    doc = _doc(s)
    o = doc["openings"]
    zs_cap = doc["permutation_zs_cap"]
    return StarkProofWithPublicInputs(
        proof=StarkProof(
            trace_cap=cap_from_json(doc["trace_cap"]),
            permutation_zs_cap=None if zs_cap is None else cap_from_json(
                zs_cap),
            quotient_polys_cap=cap_from_json(doc["quotient_polys_cap"]),
            openings=StarkOpeningSet(
                local_values=exts_from_json(o["local_values"]),
                next_values=exts_from_json(o["next_values"]),
                permutation_zs=exts_from_json(o["permutation_zs"]),
                permutation_zs_next=exts_from_json(o["permutation_zs_next"]),
                quotient_polys=exts_from_json(o["quotient_polys"])),
            opening_proof=fri_proof_from_json_dict(doc["opening_proof"])),
        public_inputs=[int(x) for x in doc["public_inputs"]])


def plonk_proof_from_json(s) -> PlonkProofWithPublicInputs:
    """A plonky2 PLONK proof from the repo's JSON (a string or its parsed
    dict).  The lookup openings may be absent (a circuit without lookups)."""
    doc = _doc(s)
    o = doc["openings"]
    return PlonkProofWithPublicInputs(
        proof=PlonkProof(
            wires_cap=cap_from_json(doc["wires_cap"]),
            plonk_zs_partial_products_cap=cap_from_json(doc["zs_pp_cap"]),
            quotient_polys_cap=cap_from_json(doc["quotient_cap"]),
            openings=PlonkOpeningSet(**{
                k: exts_from_json(o.get(k, []) if k.startswith("lookup")
                                  else o[k])
                for k in PLONK_OPENING_FIELDS}),
            opening_proof=fri_proof_from_json_dict(doc["opening_proof"])),
        public_inputs=[int(x) for x in doc["public_inputs"]])


# ----------------------------------------------------------------------------
# writers
# ----------------------------------------------------------------------------

def ext_to_json(e):
    return [int(e[0]), int(e[1])]


def _exts_to_json(v):
    return None if v is None else [ext_to_json(e) for e in v]


def proof_to_json_dict_fri(op: FriProof) -> dict:
    """The FRI opening proof as the dict the repo's JSON nests."""
    return {
        "commit_phase_merkle_caps": op.commit_phase_merkle_caps,
        "final_poly": _exts_to_json(op.final_poly),
        "pow_witness": op.pow_witness,
        "query_round_proofs": [
            {
                "initial_trees_proof": [
                    {"evals": evals, "siblings": mp.siblings}
                    for (evals, mp) in qr.initial_trees_proof.evals_proofs],
                "steps": [
                    {"evals": _exts_to_json(st.evals),
                     "siblings": st.merkle_proof.siblings}
                    for st in qr.steps],
            }
            for qr in op.query_round_proofs],
    }


def proof_to_json(pwp: StarkProofWithPublicInputs) -> str:
    """A starky proof as the repo's JSON (the inverse of
    `proof_from_json`)."""
    p = pwp.proof
    o = p.openings
    return json.dumps({
        "trace_cap": p.trace_cap,
        "permutation_zs_cap": p.permutation_zs_cap,
        "quotient_polys_cap": p.quotient_polys_cap,
        "openings": {
            "local_values": _exts_to_json(o.local_values),
            "next_values": _exts_to_json(o.next_values),
            "permutation_zs": _exts_to_json(o.permutation_zs),
            "permutation_zs_next": _exts_to_json(o.permutation_zs_next),
            "quotient_polys": _exts_to_json(o.quotient_polys),
        },
        "opening_proof": proof_to_json_dict_fri(p.opening_proof),
        "public_inputs": pwp.public_inputs,
    })


def plonk_proof_to_json(pwp: PlonkProofWithPublicInputs) -> str:
    """A plonky2 PLONK proof as the repo's JSON: caps and public inputs as
    decimal strings, every opening field, the lookup ones included (the
    inverse of `plonk_proof_from_json`)."""
    p = pwp.proof

    def cap(v):
        return [[str(x) for x in h] for h in v]

    return json.dumps({
        "wires_cap": cap(p.wires_cap),
        "zs_pp_cap": cap(p.plonk_zs_partial_products_cap),
        "quotient_cap": cap(p.quotient_polys_cap),
        "openings": {k: _exts_to_json(getattr(p.openings, k))
                     for k in PLONK_OPENING_FIELDS},
        "opening_proof": proof_to_json_dict_fri(p.opening_proof),
        "public_inputs": [str(x) for x in pwp.public_inputs],
    })


def read_jsonl(path, reader):
    """Every non-blank line of a JSON-lines file through `reader`."""
    with open(path) as f:
        return [reader(line) for line in f if line.strip()]
