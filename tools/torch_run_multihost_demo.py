"""Multi-process verification demo of the PyTorch port: 2 ranks, one
process each, form a torch.distributed world and verify a batch split over
dp x qp.  The counterpart of `tools/run_multihost_demo.py`.

Each rank loads only the proofs of its dp slice
(`parallel/distributed.py:local_batch_slice`), verifies its query slice,
and the verdicts are gathered over dp; the whole batch's verdicts must
equal the unsharded verify's, under both splits of 2 ranks (dp=2 qp=1 and
dp=1 qp=2).  The batch: the 8 FibonacciStark n=2^5 proofs of
`tests/fixtures/fib_stark_n32_x8.jsonl`, lane 3 with its proof-of-work
witness flipped and lane 6 with one Merkle sibling of query 60 replaced
(only the second query shard sees it).

Usage: python3 tools/torch_run_multihost_demo.py [--device cuda|cpu]
(default cuda: both ranks on the card, over gloo unless each has a card of
its own; cpu: gloo ranks on the CPU).
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from halo2_plonky2_verifier_tpu_torch import build_verifier  # noqa: E402
from halo2_plonky2_verifier_tpu_torch.parallel.distributed import \
    default_backend  # noqa: E402
from halo2_plonky2_verifier_tpu_torch.parallel.dryrun import (  # noqa: E402
    tiled_batch, world_verdicts)

RANKS = 2
TIMEOUT_S = 300


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    spec = {"fixture": "fib_stark_n32_x8.jsonl", "family": "fibonacci",
            "num_rows": 32, "size": 8,
            "tampers": {"3": "pow_witness", "6": "late_sibling"},
            "device": args.device,
            "backend": ("gloo" if args.device == "cpu"
                        else default_backend(RANKS)),
            "meshes": [[2, 1], [1, 2]]}
    stark, config, degree_bits, batch = tiled_batch(spec)
    want = build_verifier(stark, config, degree_bits)(batch).tolist()
    for got in world_verdicts(spec, RANKS, TIMEOUT_S):
        print(f"dp={got['dp']} qp={got['qp']} over {RANKS} ranks "
              f"({spec['backend']}, {args.device}): {got['verdicts']}",
              flush=True)
        if got["verdicts"] != want:
            raise SystemExit(f"sharded verdicts differ from the unsharded "
                             f"verify's {want}")
    print("multihost demo OK")


if __name__ == "__main__":
    main()
