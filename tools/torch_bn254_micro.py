"""Component probes of the Poseidon-BN254 body and of the card's multipliers
on a CUDA card: where the port's BN254 kernels (K4-K6) spend their time, and
what rate the card gives for the products they are made of.

The counterpart of `tools/bn254_micro.py`.  Each run is kernel K9
(`ops/bn254_micro_kernels.py`) running `chain` dependent iterations of one
function of the K4-K6 body (`csrc/poseidon_bn254.cuh`) on every lane: the
S-box's squaring with REDC, a Montgomery product, REDC alone, the S-box, a
full round, a sparse partial round on one state and on two a thread, the
permutation (sized to the card and at 128, 256 and 512 threads a block) and
K6's four-lane permutation, at `lanes` lanes; or 16 dependent u32, f32 or
wide (IMAD.WIDE.U32) multiplies, k = 1, 4 or 8 lanes a thread, at
`mul_lanes` lanes.  Each run is timed as `chip_smoke.py` times a kernel
(`utils/timing.py:cuda_ms`: the median of `reps` launches, each between its
own CUDA events, queued behind a sleep of the card) and reported as ns per
iteration per lane beside its bound (`utils/roofline.py`: the run's
multiplies at the card's published peak), with its launch (threads and
blocks).  From the same call it reports:

  parts     8 t(full_round) + 56 t(partial_round_sparse) beside t(permute):
            whether the parts add up to the permutation;
  x2/x1     t(partial_round_sparse_x2) / t(partial_round_sparse): 2 when a
            second state a thread gains nothing (`tools/bn254_micro.py`
            prints the inverse, 2 t1 / t2, as its interleave speedup);
  rates     each multiplier run's multiplies per clock per SM, at the SM
            clock `nvidia-smi` samples while it runs back to back, beside
            the peak `utils/roofline.py` assumes (64 IMAD, 128 FMUL).

Usage: python3 tools/torch_bn254_micro.py [--lanes N] [--chain C]
       [--reps R] [--out FILE]   (defaults 65536 lanes, chain 64, the TPU
       probe's, and 5 reps; the multiplier probes at 2^20 lanes; one CUDA
       card and nvcc; FILE, default build/bn254_micro/micro.json, gets
       every number)
"""

import argparse
import json
import os
import re
import statistics
import sys
import time

TOOLS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TOOLS)
sys.path.insert(0, REPO)
if TOOLS not in sys.path:
    sys.path.append(TOOLS)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_sol_bench import card_line  # noqa: E402

from halo2_plonky2_verifier_tpu_torch.constants.poseidon_bn254 import (  # noqa: E402,E501
    FULL_ROUNDS, PARTIAL_ROUNDS)
from halo2_plonky2_verifier_tpu_torch.ops import (  # noqa: E402
    _build, bn254 as fr, bn254_micro_kernels as mk9)
from halo2_plonky2_verifier_tpu_torch.utils import roofline as rl  # noqa: E402
from halo2_plonky2_verifier_tpu_torch.utils.timing import (  # noqa: E402
    SmiSampler, cuda_ms, host_ms)

LANES = 1 << 16
MUL_LANES = 1 << 20
CHAIN = 64
FR_THREADS = 512    # csrc/bn254_micro.cu: the sized Fr probes' instance
CLOCK_S = 0.4       # seconds a multiplier run runs while the clock is read
CLOCK_CSV = os.path.join(REPO, "build", "bn254_micro", "clock_smi.csv")

# (probe, threads a block (0: sized to the card), lanes a thread), in the
# order they are reported
RUNS = (("sqr_redc", 0, 1), ("mont_mul", 0, 1), ("redc", 0, 1),
        ("sbox", 0, 1), ("full_round", 0, 1), ("partial_round_sparse", 0, 1),
        ("partial_round_sparse_x2", 0, 1), ("permute", 0, 1),
        ("permute", 128, 1), ("permute", 256, 1), ("permute", 512, 1),
        ("permute_group4", 0, 1)) + tuple(
            (m, 0, k) for m in mk9.MULTIPLIERS for k in (1, 4, 8))

# probe -> (operations of one iteration on one lane, peak rate for them)
OPS = {
    "sqr_redc": (rl.BN_SQR + rl.BN_REDC, rl.IMAD_PER_S),
    "mont_mul": (rl.BN_MONT_MUL, rl.IMAD_PER_S),
    "redc": (rl.BN_REDC, rl.IMAD_PER_S),
    "sbox": (rl.BN_SBOX, rl.IMAD_PER_S),
    "full_round": (rl.BN_FULL_ROUND, rl.IMAD_PER_S),
    "partial_round_sparse": (rl.BN_PARTIAL_ROUND, rl.IMAD_PER_S),
    "partial_round_sparse_x2": (2 * rl.BN_PARTIAL_ROUND, rl.IMAD_PER_S),
    "permute": (rl.BN_PERM_MULS, rl.IMAD_PER_S),
    "permute_group4": (rl.BN_PERM_MULS, rl.IMAD_PER_S),
    "u32_mul16": (16, rl.IMAD_PER_S),
    "f32_mul16": (16, rl.F32_MUL_PER_S),
    "wide_mul16": (16, rl.IMAD_PER_S),
}
PEAK_PER_CLOCK_SM = {"u32_mul16": rl.IMAD_PER_CLOCK_SM,
                     "f32_mul16": rl.F32_MUL_PER_CLOCK_SM,
                     "wide_mul16": rl.IMAD_PER_CLOCK_SM}


def run_lanes(name, lanes=LANES, mul_lanes=MUL_LANES):
    """The lanes a run of probe `name` takes."""
    return mul_lanes if name in mk9.MULTIPLIERS else lanes


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


def kernel_instance(name, threads, k):
    """The template instance of csrc/bn254_micro.cu a run launches, as
    `instance` names it."""
    probe = mk9.PROBES[name][0]
    if name == "permute_group4":
        return "bn254_micro_group4_kernel"
    if name in mk9.MULTIPLIERS:
        return f"bn254_micro_mul_kernel<{probe},{k}>"
    return f"bn254_micro_kernel<{probe},{threads or FR_THREADS}>"


def instance(symbol):
    """A mangled kernel name -> "name<a,b>" (its integer template
    arguments), or the name alone; None for a symbol that is not one."""
    m = re.match(r"_Z(\d+)", symbol)
    if not m:
        return None
    name = symbol[m.end():m.end() + int(m.group(1))]
    args = re.match(r"I((?:Li\d+E)+)E", symbol[m.end() + len(name):])
    if not args:
        return name
    return f"{name}<{','.join(re.findall(r'Li(\d+)E', args.group(1)))}>"


def ptxas_usage(text):
    """{kernel instance: {"registers", "spill_bytes"}} from the `-Xptxas -v`
    lines of an nvcc build (spill_bytes: the spill stores)."""
    usage, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = instance(m.group(1))
            usage[current] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and current:
            usage[current]["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            usage[current]["registers"] = int(m.group(1))
    return usage


def built_usage():
    """`ptxas_usage` of the bn254_micro library's last build ({} if this
    checkout has not built it)."""
    log = _build.BUILD_DIR / "bn254_micro.log"
    return ptxas_usage(log.read_text()) if log.exists() else {}


def _runs_ms(runs, lanes, mul_lanes, chain, reps, device, rng):
    """[(name, threads, k, lanes, ms, the timed call, the launch's (threads,
    blocks) or None on the CPU)], one a run."""
    out = []
    for name, threads, k in runs:
        n = run_lanes(name, lanes, mul_lanes)
        x = probe_input(name, n, rng, device)

        def call(name=name, x=x, threads=threads, k=k):
            return mk9.run_probe(name, x, chain, threads, k)

        if device.type == "cuda":
            ms = cuda_ms(call, reps)
            launch = mk9.run_probe.last_launch
        else:
            ms, launch = host_ms(call, reps), None
        out.append((name, threads, k, n, ms, call, launch))
    return out


def _busy_mhz(calls, seconds, path):
    """The median SM clock `nvidia-smi` samples while each call runs back
    to back for `seconds` on the card (None where it took no sample)."""
    windows = []
    with SmiSampler(path) as sampler:
        for call in calls:
            torch.cuda.synchronize()
            t0 = time.time()
            while time.time() - t0 < seconds:
                call()
            torch.cuda.synchronize()
            windows.append((t0, time.time()))
    samples = sampler.samples()
    out = []
    for t0, t1 in windows:
        clk = [mhz for t, mhz, _, _ in samples if t0 <= t <= t1]
        out.append(statistics.median(clk) if clk else None)
    return out


def summarize(rows):
    """The parts, x2/x1 and rates lines of the module docstring from the
    rows of `measure` (each part where its runs are among them)."""
    ms = {(r["probe"], r["threads"], r["k"]): r["ms"] for r in rows}
    out = {}
    full, part = ms.get(("full_round", 0, 1)), ms.get(
        ("partial_round_sparse", 0, 1))
    perm = ms.get(("permute", 0, 1))
    if full is not None and part is not None and perm is not None:
        parts = FULL_ROUNDS * full + PARTIAL_ROUNDS * part
        out["parts"] = {"full_ms": full, "partial_ms": part,
                        "sum_ms": parts, "permute_ms": perm,
                        "sum_over_permute": parts / perm}
    x2 = ms.get(("partial_round_sparse_x2", 0, 1))
    if part is not None and x2 is not None:
        out["x2_over_x1"] = x2 / part
    out["rates"] = [{k: r[k] for k in ("probe", "k", "per_clock_sm",
                                       "peak_per_clock_sm", "sm_mhz")}
                    for r in rows if r["probe"] in mk9.MULTIPLIERS]
    return out


def measure(device="cuda", lanes=LANES, mul_lanes=MUL_LANES, chain=CHAIN,
            reps=5, log=None):
    """Time every run of `RUNS` on `device` (the card unless the caller
    passes device="cpu", where the plain versions run, the times are the
    CPU's and no clock is read); then, on the card, the SM clock while each
    multiplier run runs back to back for CLOCK_S seconds.  `log`, if
    given, is called with each line.  Returns (rows, summary): one row a
    run (probe, threads, k, lanes, ms, ns_per_iter_lane, bound_ms,
    bound_by, launch_threads, launch_blocks, registers, spill_bytes, and for
    the multiplier runs sm_mhz, per_clock_sm, peak_per_clock_sm) and
    `summarize`'s summary."""
    device = torch.device(device)
    rng = np.random.default_rng(0)
    timed = _runs_ms(RUNS, lanes, mul_lanes, chain, reps, device, rng)
    mul = [t for t in timed if t[0] in mk9.MULTIPLIERS]
    mhz = {}
    if device.type == "cuda" and mul:
        os.makedirs(os.path.dirname(CLOCK_CSV), exist_ok=True)
        mhz = dict(zip(((t[0], t[2]) for t in mul),
                       _busy_mhz([t[5] for t in mul], CLOCK_S, CLOCK_CSV)))
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else None)
    usage = built_usage() if device.type == "cuda" else {}
    rows = []
    for name, threads, k, n, ms, _, launch in timed:
        b_ms, b_by = probe_bound(name, n, chain)
        reg = usage.get(kernel_instance(name, threads, k), {})
        row = {"probe": name, "threads": threads, "k": k, "lanes": n,
               "ms": ms, "ns_per_iter_lane": ms * 1e6 / (chain * n),
               "bound_ms": b_ms, "bound_by": b_by,
               "launch_threads": launch[0] if launch else None,
               "launch_blocks": launch[1] if launch else None,
               "registers": reg.get("registers"),
               "spill_bytes": reg.get("spill_bytes")}
        line = (f"bn254 probe {name:23s} threads {threads:3d} k {k}: "
                f"{ms:10.4f} ms {row['ns_per_iter_lane']:10.4f} ns/iter/lane,"
                f" bound {b_ms:.4f} ms ({b_by})")
        if launch:
            line += (f"; {launch[1]} blocks of {launch[0]}, "
                     f"{row['registers']} registers, {row['spill_bytes']} B "
                     f"spill")
        if name in mk9.MULTIPLIERS:
            clock = mhz.get((name, k))
            row["sm_mhz"] = clock
            row["peak_per_clock_sm"] = PEAK_PER_CLOCK_SM[name]
            row["per_clock_sm"] = (
                16 * n * chain / (ms * 1e-3 * clock * 1e6 * sms)
                if clock else None)
            if clock:
                line += (f"; {row['per_clock_sm']:.2f} multiplies a clock "
                         f"an SM at {clock:.0f} MHz (peak "
                         f"{row['peak_per_clock_sm']})")
        rows.append(row)
        if log is not None:
            log(line)
    summary = summarize(rows)
    if log is not None:
        if "parts" in summary:
            p = summary["parts"]
            log(f"bn254 parts: 8 x full_round {p['full_ms']:.4f} + 56 x "
                f"partial_round_sparse {p['partial_ms']:.4f} = "
                f"{p['sum_ms']:.4f} ms beside permute {p['permute_ms']:.4f} "
                f"ms ({p['sum_over_permute']:.3f}x)")
        if "x2_over_x1" in summary:
            log(f"bn254 partial round x2/x1: {summary['x2_over_x1']:.3f} "
                f"(2 = no gain from a second state a thread)")
    return rows, summary


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=LANES)
    ap.add_argument("--chain", type=int, default=CHAIN)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "bn254_micro", "micro.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_bn254_micro: no CUDA card")
    card = card_line()
    print(f"device: {card}; lanes {args.lanes}, multiplier lanes "
          f"{MUL_LANES}, chain {args.chain}", flush=True)
    _build.build_all()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    rows, summary = measure(lanes=args.lanes, chain=args.chain,
                            reps=args.reps, log=lambda m: print(m, flush=True))
    with open(args.out, "w") as f:
        json.dump({"card": card, "runs": rows, "summary": summary}, f,
                  indent=1)


if __name__ == "__main__":
    main()
