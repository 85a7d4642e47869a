"""The PyTorch port's batch verification service on the command line: one
JSON request per stdin line, one JSON response per stdout line (logs on
stderr).  The protocol is `halo2_plonky2_verifier_tpu_torch/serve.py`'s,
the counterpart of `tools/serve.py`'s.

Usage: python3 tools/torch_serve.py [--device cuda|cpu] < requests.jsonl
       python3 tools/torch_serve.py --self-test [--device cuda|cpu]
The device is the card unless `--device cpu` is given.  `--self-test`
serves the fixtures of `serve.SELF_TEST` (GL FibonacciStark n=2^5, the
PlonkishStark n=2^5 proofs in the repo's JSON and in plonky2's serde JSON,
FibonacciStark n=2^5 with BN254 caps), each with a tampered proof, each
asked twice, then a malformed line, and prints `serve self-test OK`.
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from halo2_plonky2_verifier_tpu_torch.serve import (  # noqa: E402
    VerifierService, self_test)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--self-test", action="store_true")
    args = ap.parse_args()
    if args.self_test:
        self_test(args.device)
    else:
        VerifierService(args.device).run(sys.stdin, sys.stdout)


if __name__ == "__main__":
    main()
