"""Component probes of the Poseidon-BN254 permutation on a CUDA card: where
the port's BN254 kernels (K4-K6) spend their time.

The counterpart of `tools/bn254_micro.py`.  Each probe is kernel K9
(`ops/bn254_micro_kernels.py`) running `chain` dependent iterations of one
part of the K4-K6 body on every lane: square with REDC, Montgomery product by
a per-lane constant, REDC alone, the dense 4-element mix, one partial round
on one state and on two interleaved states per thread, the whole permutation
at 128, 256 and 512 threads per block, and 16 dependent u32 or f32
multiplies.  Each is timed with CUDA events over `reps` launches after a
warm-up (the median launch), and reported as ns per iteration per lane
beside its bound
(`utils/roofline.py`: the probe's multiplies at the card's peak rate, or its
bytes).

Usage: python3 tools/torch_bn254_micro.py [--lanes N] [--chain C] [--reps R]
       (defaults 65536 lanes and chain 64, the TPU probe's; one CUDA card
       and nvcc)
"""

import argparse
import os
import sys

TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(TOOLS))
if TOOLS not in sys.path:
    sys.path.append(TOOLS)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_sol_bench import card_line, time_chain  # noqa: E402

from halo2_plonky2_verifier_tpu_torch.ops import (  # noqa: E402
    bn254 as fr, bn254_micro_kernels as mk9)
from halo2_plonky2_verifier_tpu_torch.utils import roofline as rl  # noqa: E402

LANES = 1 << 16
CHAIN = 64

# (probe, threads per block), in the order they are reported
RUNS = (("sqr_redc", 128), ("mont_mul", 128), ("redc", 128), ("mix", 128),
        ("partial_round", 128), ("partial_round_x2", 128), ("permute", 128),
        ("permute", 256), ("permute", 512), ("u32_mul16", 128),
        ("f32_mul16", 128))

# probe -> (operations of one iteration on one lane, peak rate for them)
OPS = {
    "sqr_redc": (rl.BN_SQR + rl.BN_REDC, rl.IMAD_PER_S),
    "mont_mul": (rl.BN_MONT_MUL, rl.IMAD_PER_S),
    "redc": (rl.BN_REDC, rl.IMAD_PER_S),
    "mix": (rl.BN_MIX, rl.IMAD_PER_S),
    "partial_round": (rl.BN_SBOX + rl.BN_MIX, rl.IMAD_PER_S),
    "partial_round_x2": (2 * (rl.BN_SBOX + rl.BN_MIX), rl.IMAD_PER_S),
    "permute": (rl.BN_PERM_MULS, rl.IMAD_PER_S),
    "u32_mul16": (16, rl.IMAD_PER_S),
    "f32_mul16": (16, rl.F32_MUL_PER_S),
}


def probe_input(name, lanes, rng, device):
    """A seeded (rows, lanes) int64 state for probe `name`: canonical
    Montgomery Fr words (the top word below p's), or any words for the
    multiplier probes."""
    rows = mk9.PROBES[name][1]
    x = rng.integers(0, np.iinfo(np.uint64).max, size=(lanes, rows),
                     dtype=np.uint64, endpoint=True)
    if rows >= 4:
        x.reshape(lanes, rows // 4, 4)[..., 3] %= np.uint64(fr.P >> 192)
    return torch.from_numpy(x.T.copy().view(np.int64)).to(device)


def probe_bound(name, lanes, chain):
    """(bound_ms, bound_by) of one launch of probe `name`."""
    ops, rate = OPS[name]
    nbytes = 2 * mk9.PROBES[name][1] * lanes * 8
    return rl.bound(nbytes, ops * lanes * chain, rate)


def measure(device="cuda", lanes=LANES, chain=CHAIN, reps=3, log=None):
    """Time every run of `RUNS` on `device` (the card unless the caller
    passes device="cpu", where the plain versions run and the times are the
    CPU's): the median of `reps` launches, each fed the last one's output,
    after a warm-up.
    `log`, if given, is called with each run's line.  Returns one dict per
    run: probe, threads, ms, ns_per_iter_lane, bound_ms, bound_by."""
    device = torch.device(device)
    rng = np.random.default_rng(0)
    rows = []
    for name, threads in RUNS:
        x = probe_input(name, lanes, rng, device)
        ms = time_chain(lambda s: mk9.run_probe(name, s, chain, threads), x,
                        reps, device)
        b_ms, b_by = probe_bound(name, lanes, chain)
        row = {"probe": name, "threads": threads, "ms": ms,
               "ns_per_iter_lane": ms * 1e6 / (chain * lanes),
               "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        if log is not None:
            log(f"bn254 probe {name:17s} threads {threads:3d}: {ms:10.4f} ms "
                f"{row['ns_per_iter_lane']:10.4f} ns/iter/lane, bound "
                f"{b_ms:.4f} ms ({b_by})")
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=LANES)
    ap.add_argument("--chain", type=int, default=CHAIN)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_bn254_micro: no CUDA card")
    print(f"device: {card_line()}; lanes {args.lanes}, chain {args.chain}",
          flush=True)
    measure(lanes=args.lanes, chain=args.chain, reps=args.reps,
            log=lambda m: print(m, flush=True))


if __name__ == "__main__":
    main()
