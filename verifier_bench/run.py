"""Run one cell of the benchmark once, on the card, and print its result.

    python3 verifier_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout.  The last line of standard output is one JSON
object: `correct`, `attempted` and `failed` lanes, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer ones), `device`, with
`--trace 1` a `breakdown`, and last `compared`, each number compared with
its limit; the same numbers close standard error.  Exits non-zero, with no
result, without a CUDA card (or with fewer than the cell asks for), without
the program, or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def err(*args):
    print(*args, file=sys.stderr, flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--batch", type=int, default=None,
                   help="override the traffic's batch (the batch sweep)")
    args = p.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths
    cache = ROOT / "build" / "verifier_bench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path.insert(0, str(ROOT))

    from verifier_bench import harness
    cell = harness.read_json(harness.part("workloads", args.workload))
    import torch
    if not torch.cuda.is_available():
        err("no CUDA card: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        err(f"{torch.cuda.device_count()} cards, the cell asks for "
            f"{cell['chips']}")
        return 2
    if not (ROOT / "halo2_plonky2_verifier_tpu_torch").is_dir():
        err("the program (halo2_plonky2_verifier_tpu_torch) is not in this "
            "checkout")
        return 2

    result, compared = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        device="cuda", t0=T0,
        overrides=None if args.batch is None else {"batch": args.batch},
        log=err)
    found = harness.forbidden_modules(sys.modules)
    if found:
        err(f"loaded in this process: {', '.join(found)}")
        return 3
    for name, value, limit in compared:
        err(f"compared {name} {value} limit {limit}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
