"""The repo's proof fixtures and the JSON-level tampers made of them.

`read_docs` reads a fixture file of `tests/fixtures` (one proof JSON a
line); `tampered` copies a proof's JSON dict under one of `TAMPERS`, in the
repo's JSON ("native") or plonky2's serde JSON ("plonky2").  The service's
self-test (`serve.self_test`), the multi-rank runs (`parallel/dryrun.py`),
`chip_smoke.py` and the tests build their batches from these.
"""

import copy
import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
P = (1 << 64) - (1 << 32) + 1


def read_docs(name):
    """The proof JSON dicts of a fixture file, one a line."""
    with open(os.path.join(FIXTURES, name)) as f:
        return [json.loads(line) for line in f if line.strip()]


def _bumped(v):
    return (int(v) + 1) % P


def _proof_root(doc, fmt):
    """The dict that holds openings and opening_proof in `fmt`."""
    return doc["proof"] if fmt == "plonky2" else doc


def _late_sibling(doc, fmt):
    """Query 60's first initial-tree sibling of oracle 0, replaced: only
    query 60's Merkle check fails, and with the 84 queries split in two it
    lies in the second half."""
    qr = _proof_root(doc, fmt)["opening_proof"]["query_round_proofs"][60]
    if fmt == "plonky2":
        qr["initial_trees_proof"]["evals_proofs"][0][1]["siblings"][0] = {
            "elements": [9, 9, 9, 9]}
    else:
        sib = qr["initial_trees_proof"][0]["siblings"]
        sib[0] = [9, 9, 9, 9] if isinstance(sib[0], list) else 9


def _pow_witness(doc, fmt):
    op = _proof_root(doc, fmt)["opening_proof"]
    op["pow_witness"] = int(op["pow_witness"]) ^ 1


def _public_input(doc, fmt):
    doc["public_inputs"][0] = _bumped(doc["public_inputs"][0])


def _quotient_opening(doc, fmt):
    q = _proof_root(doc, fmt)["openings"]["quotient_polys"]
    q[0] = [_bumped(q[0][0]), q[0][1]]


# name -> mutate a proof's JSON dict in place, in format "native" or
# "plonky2"; each must make the verifier reject the proof
TAMPERS = {"public_input": _public_input, "pow_witness": _pow_witness,
           "quotient_opening": _quotient_opening,
           "late_sibling": _late_sibling}


def tampered(doc, name, fmt="native"):
    """A deep copy of a proof's JSON dict under tamper `name`."""
    bad = copy.deepcopy(doc)
    TAMPERS[name](bad, fmt)
    return bad
