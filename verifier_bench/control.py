"""The control and the planted faults: runs of a cell in which `correct`
has to come out false.

    python3 verifier_bench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds S] [--fault control|flip|half|stale] [--device cuda]

  control  the program's own path that breaks the configuration's
           guarantee: `build_verifier(..., check_vanishing=False)` leaves
           the quotient check at zeta out of the verdict, so a proof with a
           wrong public input (which the transcript does not observe) is
           accepted
  flip     one verdict a batch altered where it is produced
  half     the second half of each batch left out, its lanes accepted
  stale    each verify returns the previous call's verdicts (the first:
           all accepted), a step that leaves its state unchanged

Each seed is one run of the cell, in this process, one after another; the
readings (each number compared, beside its limit) print one line a seed,
then the smallest reading of each number over the seeds.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def flip(verify):
    def run(batch):
        v = verify(batch).clone()
        v[0] = ~v[0]
        return v
    return run


def half(verify):
    def run(batch):
        v = verify(batch).clone()
        v[v.shape[0] // 2:] = True
        return v
    return run


def stale(verify):
    last = []

    def run(batch):
        v = verify(batch)
        out = last[0] if last else v.new_ones(v.shape)
        last[:] = [v]
        return out
    return run


FAULTS = {"control": ({"check_vanishing": False}, None), "flip": ({}, flip),
          "half": ({}, half), "stale": ({}, stale)}


def readings(workload, seeds, seconds, fault, device="cuda", overrides=None):
    """[(seed, {number: value}, correct)] of the cell's runs under `fault`."""
    from verifier_bench import harness
    options, wrap = FAULTS[fault]
    out = []
    for seed in seeds:
        result, compared = harness.run_cell(
            workload, seed, seconds, False, device=device,
            overrides=overrides, make_verify=wrap, program_options=options)
        out.append((seed, {n: v for n, v, _ in compared}, result["correct"]))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--fault", choices=sorted(FAULTS), default="control")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                    args.seconds, args.fault, args.device)
    for seed, nums, correct in rows:
        print(json.dumps({"fault": args.fault, "seed": seed,
                          "correct": correct, "compared": nums}), flush=True)
    least = {k: min(r[1][k] for r in rows) for k in rows[0][1]}
    print(json.dumps({"fault": args.fault, "workload": args.workload,
                      "least": least,
                      "all_incorrect": not any(r[2] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
