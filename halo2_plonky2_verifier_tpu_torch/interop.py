"""plonky2 serde-JSON proof readers and writers: proofs serialized by a
Rust plonky2 / starky toolchain enter the port directly, and the port's
proofs leave in that form.

Copies of the decoders of `halo2_plonky2_verifier_tpu/interop.py`
(`_hash_dec` ... `_merkle_proof_dec` :59-106, `fri_proof_dec` :133,
`stark_proof_from_plonky2_json` :187, `plonk_proof_from_plonky2_json`
:240), returning the dataclasses of `proof_json.py`, and of its encoders
(`_hash_enc` ... `_merkle_proof_enc` :59-102, `fri_proof_enc` :108,
`stark_proof_to_plonky2_json` :161, `plonk_proof_to_plonky2_json` :221),
which give the JAX package's strings.  The struct layout is the serde
derive of plonky2's own types:

  GoldilocksField(u64)          -> a JSON number
  QuadraticExtension([F; 2])    -> [a0, a1]
  HashOut { elements: [F; 4] }  -> {"elements": [..4]}
  MerkleCap(Vec<Hash>)          -> [hash, ...]
  MerkleProof { siblings }      -> {"siblings": [...]}
  PolynomialCoeffs { coeffs }   -> {"coeffs": [...]}
  FriInitialTreeProof { evals_proofs: Vec<(Vec<F>, MerkleProof)> }
  FriQueryStep { evals, merkle_proof }; FriQueryRound { initial_trees_proof,
  steps }; FriProof { commit_phase_merkle_caps, query_round_proofs,
  final_poly, pow_witness }
  starky StarkProofWithPublicInputs { proof: StarkProof { trace_cap,
  permutation_zs_cap, quotient_polys_cap, openings, opening_proof },
  public_inputs }
  plonky2 ProofWithPublicInputs { proof: Proof { wires_cap,
  plonk_zs_partial_products_cap, quotient_polys_cap, openings,
  opening_proof }, public_inputs }

A serde `HashOut` holds 4 Goldilocks elements, so a proof with BN254 caps
has no serde form: `_hash_enc` raises ValueError for a BN254 hash (one
int), where the JAX one fails with a TypeError.
"""

import json

from .proof_json import (PLONK_OPENING_FIELDS, FriInitialTreeProof, FriProof,
                         FriQueryRound, FriQueryStep, MerkleProof,
                         PlonkOpeningSet, PlonkProof,
                         PlonkProofWithPublicInputs, StarkOpeningSet,
                         StarkProof, StarkProofWithPublicInputs,
                         proof_from_json)


def _hash_enc(h):
    if not isinstance(h, (list, tuple)):
        raise ValueError("a BN254 hash has no plonky2 serde form: HashOut "
                         "holds 4 Goldilocks elements")
    return {"elements": [int(x) for x in h]}


def _cap_enc(cap):
    return [_hash_enc(h) for h in cap]


def _ext_enc(e):
    return [int(e[0]), int(e[1])]


def _exts_enc(es):
    return [_ext_enc(e) for e in es]


def _merkle_proof_enc(mp):
    return {"siblings": [_hash_enc(h) for h in mp.siblings]}


def _hash_dec(d):
    e = d["elements"]
    if len(e) != 4:
        raise ValueError(f"HashOut needs 4 elements, got {len(e)}")
    return [int(x) for x in e]


def _cap_dec(v):
    return [_hash_dec(h) for h in v]


def _ext_dec(v):
    if len(v) != 2:
        raise ValueError("QuadraticExtension needs 2 coordinates")
    return (int(v[0]), int(v[1]))


def _exts_dec(v):
    return [_ext_dec(e) for e in v]


def _merkle_proof_dec(d):
    return MerkleProof(siblings=[_hash_dec(h) for h in d["siblings"]])


def fri_proof_dec(d: dict) -> FriProof:
    return FriProof(
        commit_phase_merkle_caps=[_cap_dec(c)
                                  for c in d["commit_phase_merkle_caps"]],
        query_round_proofs=[
            FriQueryRound(
                initial_trees_proof=FriInitialTreeProof(evals_proofs=[
                    ([int(x) for x in ep[0]], _merkle_proof_dec(ep[1]))
                    for ep in qr["initial_trees_proof"]["evals_proofs"]]),
                steps=[
                    FriQueryStep(evals=_exts_dec(st["evals"]),
                                 merkle_proof=_merkle_proof_dec(
                                     st["merkle_proof"]))
                    for st in qr["steps"]])
            for qr in d["query_round_proofs"]],
        final_poly=_exts_dec(d["final_poly"]["coeffs"]),
        pow_witness=int(d["pow_witness"]),
    )


def fri_proof_enc(fp: FriProof) -> dict:
    return {
        "commit_phase_merkle_caps": [_cap_enc(c)
                                     for c in fp.commit_phase_merkle_caps],
        "query_round_proofs": [
            {
                "initial_trees_proof": {"evals_proofs": [
                    [[int(x) for x in evals], _merkle_proof_enc(mp)]
                    for (evals, mp) in qr.initial_trees_proof.evals_proofs]},
                "steps": [
                    {"evals": _exts_enc(st.evals),
                     "merkle_proof": _merkle_proof_enc(st.merkle_proof)}
                    for st in qr.steps],
            }
            for qr in fp.query_round_proofs],
        "final_poly": {"coeffs": _exts_enc(fp.final_poly)},
        "pow_witness": int(fp.pow_witness),
    }


def _doc(s):
    return json.loads(s) if isinstance(s, (str, bytes)) else s


def stark_proof_from_plonky2_json(s) -> StarkProofWithPublicInputs:
    doc = _doc(s)
    p = doc["proof"]
    o = p["openings"]

    def optional(d, k, dec):
        return None if d.get(k) is None else dec(d[k])

    return StarkProofWithPublicInputs(
        proof=StarkProof(
            trace_cap=_cap_dec(p["trace_cap"]),
            permutation_zs_cap=optional(p, "permutation_zs_cap", _cap_dec),
            quotient_polys_cap=_cap_dec(p["quotient_polys_cap"]),
            openings=StarkOpeningSet(
                local_values=_exts_dec(o["local_values"]),
                next_values=_exts_dec(o["next_values"]),
                permutation_zs=optional(o, "permutation_zs", _exts_dec),
                permutation_zs_next=optional(o, "permutation_zs_next",
                                             _exts_dec),
                quotient_polys=_exts_dec(o["quotient_polys"])),
            opening_proof=fri_proof_dec(p["opening_proof"])),
        public_inputs=[int(x) for x in doc["public_inputs"]])


def stark_proof_to_plonky2_json(pwp: StarkProofWithPublicInputs) -> str:
    """A starky proof as plonky2's serde JSON (Goldilocks caps only)."""
    p = pwp.proof
    o = p.openings

    def optional(v, enc):
        return None if v is None else enc(v)

    return json.dumps({
        "proof": {
            "trace_cap": _cap_enc(p.trace_cap),
            "permutation_zs_cap": optional(p.permutation_zs_cap, _cap_enc),
            "quotient_polys_cap": _cap_enc(p.quotient_polys_cap),
            "openings": {
                "local_values": _exts_enc(o.local_values),
                "next_values": _exts_enc(o.next_values),
                "permutation_zs": optional(o.permutation_zs, _exts_enc),
                "permutation_zs_next": optional(o.permutation_zs_next,
                                                _exts_enc),
                "quotient_polys": _exts_enc(o.quotient_polys),
            },
            "opening_proof": fri_proof_enc(p.opening_proof),
        },
        "public_inputs": [int(x) for x in pwp.public_inputs],
    })


def plonk_proof_to_plonky2_json(pwp: PlonkProofWithPublicInputs) -> str:
    """A plonky2 PLONK proof as plonky2's serde JSON, every opening field
    (the lookup ones included)."""
    p = pwp.proof
    return json.dumps({
        "proof": {
            "wires_cap": _cap_enc(p.wires_cap),
            "plonk_zs_partial_products_cap": _cap_enc(
                p.plonk_zs_partial_products_cap),
            "quotient_polys_cap": _cap_enc(p.quotient_polys_cap),
            "openings": {k: _exts_enc(getattr(p.openings, k))
                         for k in PLONK_OPENING_FIELDS},
            "opening_proof": fri_proof_enc(p.opening_proof),
        },
        "public_inputs": [int(x) for x in pwp.public_inputs],
    })


def plonk_proof_from_plonky2_json(s) -> PlonkProofWithPublicInputs:
    """The seven pre-lookup OpeningSet fields are mandatory (a missing key
    fails here as a parse error); the lookup columns are absent on a
    lookup-free circuit."""
    doc = _doc(s)
    p = doc["proof"]
    o = p["openings"]
    return PlonkProofWithPublicInputs(
        proof=PlonkProof(
            wires_cap=_cap_dec(p["wires_cap"]),
            plonk_zs_partial_products_cap=_cap_dec(
                p["plonk_zs_partial_products_cap"]),
            quotient_polys_cap=_cap_dec(p["quotient_polys_cap"]),
            openings=PlonkOpeningSet(**{
                k: _exts_dec(o.get(k, []) if k.startswith("lookup")
                             else o[k])
                for k in PLONK_OPENING_FIELDS}),
            opening_proof=fri_proof_dec(p["opening_proof"])),
        public_inputs=[int(x) for x in doc["public_inputs"]])


# a STARK proof's reader by the name of its format: the repo's JSON
# ("native") or plonky2's serde JSON
READERS = {"native": proof_from_json,
           "plonky2": stark_proof_from_plonky2_json}
