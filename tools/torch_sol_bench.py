"""Speed-of-light probes of the Goldilocks multiply and the
Poseidon-Goldilocks permutation on a CUDA card, for the PyTorch port's
roofline accounting.

`measure_gl_mul_sol` is the counterpart of `tools/sol_bench.py:
measure_gl_mul_sol`, with its signature and defaults: kernel K10
(`ops/goldilocks_kernels.py:mul_chain`) runs `chain` = 256 dependent
products x <- x * y on each element of (8, 2^21) planes, three serially
dependent reps after a warm-up call, one synchronise after the last.  Its
rate is the denominator of BASELINE.json's "Goldilocks muls/sec vs SOL":
pct_speed_of_light = census gl_mul per proof x proofs/s / this rate.

`measure_poseidon_sol` is the counterpart of `tools/sol_bench.py:
measure_poseidon_sol`, at its sizes:

  chained       K8, 64 permutations in a row on each of 2^18 states held in
                registers (one read and one write of the state for all 64);
  streamed      K7, one permutation on each of 2^21 states;
  mid           K8, 4 permutations on each of 2^20 states;
  merkle-path   K1, the Merkle-path kernel at d_max = 8 over 2^19 paths, all
                levels active (index 0).

Each probe feeds its output back as the next input (serially dependent
reps), after one warm-up call; its time is the median rep, timed with CUDA
events between the reps (on the CPU, with the host clock).  It reports
permutations per second and its share of the bound rate: the least time
the card could take for the same work (`utils/roofline.py`, the
permutation's 6,436 multiplies or its bytes) over the time taken.

Usage: python3 tools/torch_sol_bench.py [--reps N]   (one CUDA card, nvcc)
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from halo2_plonky2_verifier_tpu_torch.ops import (  # noqa: E402
    goldilocks as gl, goldilocks_kernels as glk, merkle_kernels as mk,
    poseidon_kernels as pk)
from halo2_plonky2_verifier_tpu_torch.utils import roofline  # noqa: E402

# name, kernel, lanes, depth (K8: permutations in a row; K1: d_max)
PROBES = (
    ("chained", "K8", 1 << 18, 64),
    ("streamed", "K7", 1 << 21, 1),
    ("mid", "K8", 1 << 20, 4),
    ("merkle-path", "K1", 1 << 19, 8),
)


def card_line():
    """The card's name and power limit, as `nvidia-smi` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def time_chain(fn, x, reps, device):
    """Median milliseconds of one call of x <- fn(x) over `reps` calls in a
    row after one warm-up call; a CUDA event between calls on the card, the
    host clock on the CPU.  The median, because the card idles while the
    host that enqueues the next call is held up (its cores may be shared),
    and one held-up call must not set the result."""
    x = fn(x)
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            x = fn(x)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    torch.cuda.synchronize(device)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    events[0].record()
    for e in events[1:]:
        x = fn(x)
        e.record()
    torch.cuda.synchronize(device)
    return statistics.median(a.elapsed_time(b)
                             for a, b in zip(events, events[1:]))


def measure_gl_mul_sol(n_lanes=1 << 21, chain=256, reps=3, device="cuda"):
    """Goldilocks products per second of K10 on `device` (the card unless
    the caller passes device="cpu"; the plain version and the CPU's rate
    then).  x and y are (8, n_lanes) planes from numpy's default_rng(0), as
    the JAX probe draws them; each rep multiplies every element `chain`
    times and feeds the result to the next rep.  Returns (gl_mul_per_sec,
    seconds_per_rep)."""
    device = torch.device(device)
    rng = np.random.default_rng(0)
    x = gl.from_u64(rng.integers(0, gl.P, size=(8, n_lanes),
                                 dtype=np.uint64), device)
    y = gl.from_u64(rng.integers(1, gl.P, size=(8, n_lanes),
                                 dtype=np.uint64), device)
    x = glk.mul_chain(x, y, chain)          # warm: build and first launch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        x = glk.mul_chain(x, y, chain)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = (time.perf_counter() - t0) / reps
    return 8 * n_lanes * chain / dt, dt


def _probe_call(kernel, lanes, depth, rng, device):
    """(fn, first input, permutations per call, bytes per call)."""
    def rand(shape):
        return gl.from_u64(rng.integers(0, gl.P, size=shape, dtype=np.uint64),
                           device)

    if kernel == "K7":
        return pk.permute_planes, rand((12, lanes)), lanes, 2 * 12 * lanes * 8
    if kernel == "K8":
        return ((lambda s: pk.permute_planes_chained(s, depth)),
                rand((12, lanes)), lanes * depth, 2 * 12 * lanes * 8)
    sib = rand((depth, 4, lanes))
    idx = torch.zeros(lanes, dtype=torch.int64, device=device)
    active = torch.ones((depth, lanes), dtype=torch.int32, device=device)
    return ((lambda node: mk.verify_paths_planes(node, sib, idx, active)),
            rand((4, lanes)), lanes * depth,
            lanes * (32 + 8 + 32) + depth * lanes * (32 + 4))


def measure_poseidon_sol(device="cuda", reps=3, probes=PROBES, log=None):
    """Run each probe of `probes` (name, kernel, lanes, depth) on `device`;
    the kernels run on the card unless the caller passes device="cpu" (their
    plain versions then run, and the rates are the CPU's).  `log`, if given,
    is called with each probe's line.  Returns (perm_per_sec, seconds per
    rep) of the fastest probe, as `tools/sol_bench.py` does, and one dict
    per probe: name, kernel, lanes, depth, ms, perm_per_sec, bound_ms,
    bound_by, share (bound_ms / ms)."""
    device = torch.device(device)
    rng = np.random.default_rng(1)
    rows = []
    for name, kernel, lanes, depth in probes:
        fn, x, perms, nbytes = _probe_call(kernel, lanes, depth, rng, device)
        ms = time_chain(fn, x, reps, device)
        b_ms, b_by = roofline.bound(nbytes, perms * roofline.GL_PERM_MULS)
        row = {"name": name, "kernel": kernel, "lanes": lanes, "depth": depth,
               "ms": ms, "perm_per_sec": perms / ms * 1e3, "bound_ms": b_ms,
               "bound_by": b_by, "share": b_ms / ms}
        rows.append(row)
        if log is not None:
            log(f"sol probe {name:12s} ({kernel}, {lanes} lanes, depth "
                f"{depth}): {row['perm_per_sec'] / 1e6:9.2f} M perm/s, "
                f"{ms:.4f} ms/rep, bound {b_ms:.4f} ms ({b_by}), share "
                f"{row['share']:.4f}")
    best = max(rows, key=lambda r: r["perm_per_sec"])
    return best["perm_per_sec"], best["ms"] / 1e3, rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_sol_bench: no CUDA card")
    print(f"device: {card_line()}", flush=True)
    rate, sec = measure_gl_mul_sol(reps=args.reps)
    b_ms, b_by = roofline.bound(*roofline.gl_mul_chain(8 << 21, 256))
    print(f"gl_mul speed of light (K10, 8 x 2^21 lanes, chain 256): "
          f"{rate / 1e9:.3f} G mul/s ({sec * 1e3:.4f} ms/rep), bound "
          f"{b_ms:.4f} ms ({b_by}), share {b_ms / (sec * 1e3):.4f}",
          flush=True)
    pps, sec, _ = measure_poseidon_sol(reps=args.reps,
                                       log=lambda m: print(m, flush=True))
    print(f"poseidon permutation speed of light: {pps / 1e6:.2f} M perm/s "
          f"({sec * 1e3:.4f} ms/rep)", flush=True)


if __name__ == "__main__":
    main()
