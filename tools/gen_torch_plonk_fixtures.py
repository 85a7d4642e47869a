"""Write the PLONK circuit fixtures that the PyTorch port's PLONK verifier
reads, with the JAX package's pure-Python circuit builder and prover (no
download, no accelerator).

The port has no circuit builder: `halo2_plonky2_verifier_tpu_torch/circuit/
common.py:load_circuit` rebuilds a circuit's `common` and `verifier_data`
from one of these files.  Each holds the config and FRI config,
`degree_bits`, the gates in circuit order by id and parameters, the
selector groups, `num_gate_constraints`, `num_constants`, `k_is`, the
lookup tables, `constants_sigmas_cap` and `circuit_digest`, and beside them
the proofs file of the circuit and the JAX package's verdict
(`refimpl.plonk.verify` accepts or raises) on every proof of that file,
untouched and under each tamper of `TAMPERS`:

  tests/fixtures/plonk_circuit_recmix_s60.json
      `refimpl/fixtures.py:bench_plonk_circuit` (the bench's PLONK circuit:
      the standard_recursion gate mix at 135 wires, 80 routed, 28 queries);
      proofs plonk_recmix_s60_x4.jsonl (and _x32, the same circuit);
  tests/fixtures/plonk_circuit_recursive_fib_n8.json
      the recursive verifier of `refimpl/fixtures.py:recursive_fib_setup`
      (8 queries); proofs recursive_fib_n8_x2.jsonl;
  tests/fixtures/plonk_circuit_fib_small.json
      the small fib circuit of `tests/test_plonk.py:build_fib_circuit` under
      `small_fri(4)`; proofs plonk_fib_small_x3.jsonl (written here);
  tests/fixtures/plonk_circuit_logup.json
      the two-table logUp circuit of `tests/test_plonk_lookup.py:
      _build_lookup_circuit`; proofs plonk_logup_x4.jsonl (written here).

The proof files that exist already are read, never rewritten.  Nothing in
the port imports this tool; the port's tests import `TAMPERS`.

Usage: JAX_PLATFORMS=cpu python tools/gen_torch_plonk_fixtures.py
(about 15 s on one CPU core, most of it refimpl's verdicts).
"""

import copy
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from halo2_plonky2_verifier_tpu_torch.circuit.common import \
    circuit_to_json  # noqa: E402

FIXTURES = os.path.join(REPO, "tests", "fixtures")
P = (1 << 64) - (1 << 32) + 1


def _bumped(v):
    """v + 1 mod p, in the JSON type it had (a number or a string)."""
    w = (int(v) + 1) % P
    return str(w) if isinstance(v, str) else w


def _bump_ext(exts, i):
    exts[i] = [_bumped(exts[i][0]), exts[i][1]]


def _public_input(d):
    pis = d["public_inputs"]
    i = min(2, len(pis) - 1)
    pis[i] = _bumped(pis[i])


def _sibling(d):
    qr = d["opening_proof"]["query_round_proofs"][1]
    qr["initial_trees_proof"][2]["siblings"][0] = [9, 9, 9, 9]


# name -> (applies to the circuit, mutate the refimpl-JSON dict of a proof);
# the first three are the tampered lanes of tests/test_plonk_jax.py:37-46
TAMPERS = {
    "public_input": (lambda c: True, _public_input),
    "wire_opening": (lambda c: True,
                     lambda d: _bump_ext(d["openings"]["wires"], 3)),
    "sibling": (lambda c: True, _sibling),
    "quotient_opening": (lambda c: True, lambda d: _bump_ext(
        d["openings"]["quotient_polys"], 0)),
    "lookup_z": (lambda c: bool(c.luts), lambda d: _bump_ext(
        d["openings"]["lookup_zs"], 0)),
}


def tampered(doc, name):
    """A deep copy of a proof's refimpl-JSON dict under tamper `name`."""
    bad = copy.deepcopy(doc)
    TAMPERS[name][1](bad)
    return bad


def tamper_names(common):
    return [n for n, (applies, _) in TAMPERS.items() if applies(common)]


def refimpl_verdicts(common, vd, docs):
    """[{"index", "tamper", "accepted"}]: refimpl's verdict on every proof,
    untouched (tamper None) and under each tamper, proof i % len(docs)
    taking the i-th tamper."""
    from halo2_plonky2_verifier_tpu.refimpl.plonk import (
        plonk_proof_from_json, verify)
    from halo2_plonky2_verifier_tpu.refimpl.verifier import VerificationError

    def accepted(doc):
        try:
            verify(common, vd, plonk_proof_from_json(json.dumps(doc)))
            return True
        except VerificationError:
            return False

    out = [{"index": i, "tamper": None, "accepted": accepted(d)}
           for i, d in enumerate(docs)]
    for k, name in enumerate(tamper_names(common)):
        i = k % len(docs)
        out.append({"index": i, "tamper": name,
                    "accepted": accepted(tampered(docs[i], name))})
    return out


def _recmix():
    from halo2_plonky2_verifier_tpu.refimpl.fixtures import \
        bench_plonk_circuit
    b, _ = bench_plonk_circuit(steps=60)
    common, _, vd, _ = b.build()
    return common, vd, "plonk_recmix_s60_x4.jsonl", None


def _recursive_fib():
    from halo2_plonky2_verifier_tpu.refimpl.fixtures import \
        recursive_fib_setup
    *_, b, _ = recursive_fib_setup(8, 2)
    common, _, vd, _ = b.build()
    return common, vd, "recursive_fib_n8_x2.jsonl", None


def _fib_small():
    from halo2_plonky2_verifier_tpu.refimpl.plonk import (CircuitConfig,
                                                          prove)
    from test_plonk import build_fib_circuit, small_fri

    b, (a, x) = build_fib_circuit(CircuitConfig(fri_config=small_fri(4)))
    common, pd, vd, builder = b.build()

    def proofs():
        return [prove(common, pd, builder, {a: i + 1, x: 2 * i + 1})
                for i in range(3)]
    return common, vd, "plonk_fib_small_x3.jsonl", proofs


def _logup():
    from halo2_plonky2_verifier_tpu.refimpl.plonk import prove
    from test_plonk_lookup import _build_lookup_circuit

    common, pd, vd, builder, x = _build_lookup_circuit()

    def proofs():
        return [prove(common, pd, builder, {x: v}) for v in (5, 0, 9, 15)]
    return common, vd, "plonk_logup_x4.jsonl", proofs


# file tag -> (circuit name, as `golden_anchors.json` names it, and builder)
CIRCUITS = {"recmix_s60": ("plonk_recmix_s60", _recmix),
            "recursive_fib_n8": ("recursive_fib_n8", _recursive_fib),
            "fib_small": ("fib_small", _fib_small),
            "logup": ("logup", _logup)}


def write_circuit(tag):
    from halo2_plonky2_verifier_tpu.refimpl.plonk import plonk_proof_to_json

    name, build = CIRCUITS[tag]
    common, vd, proofs_file, make_proofs = build()
    path = os.path.join(FIXTURES, proofs_file)
    if not os.path.exists(path):
        with open(path, "w") as f:
            for pwp in make_proofs():
                f.write(plonk_proof_to_json(pwp) + "\n")
    with open(path) as f:
        docs = [json.loads(line) for line in f if line.strip()]
    doc = circuit_to_json(
        common, vd, name, num_public_inputs=len(docs[0]["public_inputs"]),
        proofs=proofs_file,
        refimpl_verdicts=refimpl_verdicts(common, vd, docs))
    out = os.path.join(FIXTURES, f"plonk_circuit_{tag}.json")
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return out


def main():
    for tag in CIRCUITS:
        print("wrote", write_circuit(tag), flush=True)


if __name__ == "__main__":
    main()
