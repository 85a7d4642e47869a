"""Write the PlonkishStark proof fixtures that the PyTorch port's tests,
service and `chip_smoke.py` read, with the JAX package's pure-Python prover
(no download, no accelerator).

Each proof is a distinct `build_mul_add_chain` circuit (x0 = 3, 4, ...)
proved by refimpl under `standard_fast_config`:

  tests/fixtures/plonkish_n2048_x8.jsonl        8 proofs, n=2^11, the repo's
                                                JSON, one proof a line;
  tests/fixtures/plonkish_n32_x8.jsonl          8 proofs, n=2^5;
  tests/fixtures/plonkish_n32_x4_plonky2.jsonl  the first 4 of those in
                                                plonky2's serde JSON
                                                (`interop.stark_proof_to_
                                                plonky2_json`): the port
                                                reads that format but has
                                                no writer;
  tests/fixtures/plonkish_n32_bad_gate.jsonl    one proof of a trace whose
                                                gate at row 5 is broken: its
                                                FRI holds, its quotient does
                                                not satisfy the constraint;
  tests/fixtures/plonkish_verdicts.json         refimpl's verdict
                                                (`refimpl/verifier.py:verify`
                                                accepts or raises) on every
                                                proof, untouched and under
                                                each JSON-level tamper of
                                                the port's `fixtures.TAMPERS`
                                                (proof i % count takes the
                                                i-th), and on the bad-gate
                                                proof with and without the
                                                vanishing check.

Usage: JAX_PLATFORMS=cpu python tools/gen_torch_plonkish_fixtures.py
(about 80 s on one CPU core, most of it refimpl's verdicts at n=2^11).
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from halo2_plonky2_verifier_tpu_torch.fixtures import (  # noqa: E402
    TAMPERS, tampered)

FIXTURES = os.path.join(REPO, "tests", "fixtures")
VERDICTS = "plonkish_verdicts.json"
# file -> (num_rows, format, x0 of each proof)
FILES = {
    "plonkish_n2048_x8.jsonl": (2048, "native", list(range(3, 11))),
    "plonkish_n32_x8.jsonl": (32, "native", list(range(3, 11))),
    "plonkish_n32_x4_plonky2.jsonl": (32, "plonky2", list(range(3, 7))),
}
BAD_GATE = "plonkish_n32_bad_gate.jsonl"


def prove(num_rows, x0, break_gate=False):
    from halo2_plonky2_verifier_tpu.models.plonkish import build_mul_add_chain
    from halo2_plonky2_verifier_tpu.refimpl import field as gl
    from halo2_plonky2_verifier_tpu.refimpl import prover
    from halo2_plonky2_verifier_tpu.utils.config import StarkConfig

    stark, trace, pis = build_mul_add_chain(num_rows, x0, x0, gl.P)
    if break_gate:
        trace[2][5] = (trace[2][5] + 1) % gl.P
    return prover.prove(stark, StarkConfig.standard_fast_config(), trace, pis)


def to_json(pwp, fmt):
    from halo2_plonky2_verifier_tpu.interop import stark_proof_to_plonky2_json
    from halo2_plonky2_verifier_tpu.refimpl.proof import proof_to_json

    return (stark_proof_to_plonky2_json(pwp) if fmt == "plonky2"
            else proof_to_json(pwp))


def accepted(num_rows, doc, fmt, check_vanishing=True):
    """refimpl's verdict on a proof's JSON dict."""
    from halo2_plonky2_verifier_tpu.interop import \
        stark_proof_from_plonky2_json
    from halo2_plonky2_verifier_tpu.models.plonkish import PlonkishStark
    from halo2_plonky2_verifier_tpu.refimpl import verifier
    from halo2_plonky2_verifier_tpu.refimpl.proof import proof_from_json
    from halo2_plonky2_verifier_tpu.utils.config import StarkConfig

    read = (stark_proof_from_plonky2_json if fmt == "plonky2"
            else proof_from_json)
    try:
        verifier.verify(PlonkishStark(num_rows), read(json.dumps(doc)),
                        StarkConfig.standard_fast_config(), check_vanishing)
        return True
    except verifier.VerificationError:
        return False


def write_lines(name, texts):
    with open(os.path.join(FIXTURES, name), "w") as f:
        for t in texts:
            f.write(t + "\n")


def main():
    out = {"config": "standard_fast_config", "files": {}}
    proofs32 = {}
    for name, (num_rows, fmt, x0s) in FILES.items():
        pwps = [proofs32[x0] if num_rows == 32 and x0 in proofs32
                else prove(num_rows, x0) for x0 in x0s]
        if num_rows == 32:
            proofs32.update(zip(x0s, pwps))
        texts = [to_json(p, fmt) for p in pwps]
        write_lines(name, texts)
        docs = [json.loads(t) for t in texts]
        verdicts = [{"index": i, "tamper": None,
                     "accepted": accepted(num_rows, d, fmt)}
                    for i, d in enumerate(docs)]
        for k, tamper in enumerate(TAMPERS):
            i = k % len(docs)
            verdicts.append({"index": i, "tamper": tamper, "accepted": accepted(
                num_rows, tampered(docs[i], tamper, fmt), fmt)})
        out["files"][name] = {"num_rows": num_rows, "format": fmt, "x0": x0s,
                              "verdicts": verdicts}
        print("wrote", name, flush=True)

    bad = json.loads(to_json(prove(32, 3, break_gate=True), "native"))
    write_lines(BAD_GATE, [json.dumps(bad)])
    out["files"][BAD_GATE] = {
        "num_rows": 32, "format": "native", "x0": [3], "break_gate_row": 5,
        "verdicts": [{"index": 0, "tamper": None, "check_vanishing": cv,
                      "accepted": accepted(32, bad, "native", cv)}
                     for cv in (True, False)]}
    with open(os.path.join(FIXTURES, VERDICTS), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print("wrote", BAD_GATE, VERDICTS, flush=True)


if __name__ == "__main__":
    main()
