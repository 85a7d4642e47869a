#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (written for an H100).

Drives `halo2_plonky2_verifier_tpu_torch` on the card, in phases:

  1. device: the card's name and power limit;
  2. build: nvcc for every kernel of the verifier's path, all at once;
  3. kernels: K1 (Merkle paths), K2 (transcript) and K3 (leaf sponge), each
     against its plain PyTorch version on the same seeded inputs at the
     shapes of the main path; the results must be equal (tolerance 0: these
     are integers), and both are timed on the card;
  4. the fold shape: FibonacciStark n=2^11, B=1024 (the columnar fixture
     tiled), through `build_verifier`; every verdict must be True, every
     kernel of the path must have launched, a tampered batch must give the
     expected verdicts, and its first 32 lanes must match the plain path run
     on the CPU;
  5. the flagship shape n=2^5, B=4096, with the same checks (no leaf sponge
     on this shape);
  6. one JSON line listing the kernels; the last line is
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failure raises, and the script exits non-zero without the last line.

Usage: python3 chip_smoke.py        (needs one CUDA card and nvcc)
"""

import json
import os
import subprocess
import time

import numpy as np
import torch

from halo2_plonky2_verifier_tpu_torch import (StarkConfig, build_verifier,
                                              proof_shape, stark, transcript,
                                              witness)
from halo2_plonky2_verifier_tpu_torch.models.fibonacci import FibonacciStark
from halo2_plonky2_verifier_tpu_torch.ops import _build
from halo2_plonky2_verifier_tpu_torch.ops import goldilocks as gl
from halo2_plonky2_verifier_tpu_torch.ops import merkle_kernels as mk
from halo2_plonky2_verifier_tpu_torch.ops import transcript_kernels as tk

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
SEED = 20261016
DEVICE = "cuda"


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters):
    """Mean milliseconds of fn() on the card over `iters` runs, after one
    warm-up run (CUDA events around the whole run)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rand_gl(rng, shape):
    """Seeded field elements below p, with 0 and p - 1 among them."""
    x = rng.integers(0, gl.P, size=shape, dtype=np.uint64)
    flat = x.reshape(-1)
    flat[0] = 0
    flat[1] = gl.P - 1
    return x


def max_abs_err(a, b):
    """Largest |a - b| over the u64 values of two int64 tensors."""
    x, y = gl.to_u64(a), gl.to_u64(b)
    if x.shape != y.shape:
        raise AssertionError(f"shape {x.shape} != {y.shape}")
    return float(np.where(x >= y, x - y, y - x).max()) if x.size else 0.0


def check_kernels(rng):
    """Phase 3: each kernel against its plain version at main-path shapes."""
    dev = DEVICE
    B, Q = 1024, 84
    m = B * Q
    results = {}

    # K1: the n=2^11 slots (3 oracles of depth 8, step trees of depth 4, 0)
    depths = (8, 8, 8, 4, 0)
    d_max, n = max(depths), len(depths) * m
    node = gl.from_u64(rand_gl(rng, (4, n)), dev)
    sib = gl.from_u64(rand_gl(rng, (d_max, 4, n)), dev)
    idx = torch.from_numpy(rng.integers(0, 1 << d_max, size=n)).to(dev)
    level_active = np.zeros((d_max, len(depths)), dtype=np.int32)
    for s, d in enumerate(depths):
        level_active[:d, s] = 1
    active = torch.from_numpy(np.repeat(level_active, m, axis=1)).to(dev)
    args = (node, sib, idx, active)
    results["K1"] = (lambda: mk.verify_paths_planes(*args),
                     lambda: mk.verify_paths_planes_plain(*args),
                     f"N={n} d_max={d_max}")

    # K2: the transcript schedule of the n=2^11 proofs, B=1024
    shape = fibonacci_shape(2048, 11)[2]
    one = witness.load_batch_npz(
        os.path.join(FIXTURES, "fib_stark_n2048_x8.npz"), shape, "cpu")
    sched, _, _ = stark.challenge_stream(one)
    _, mask = transcript.schedule_tables(sched, dev)
    n_steps = len(sched.steps)
    chunks = gl.from_u64(rand_gl(rng, (n_steps, 8, B)), dev)
    results["K2"] = (lambda: tk.run_steps_planes(chunks, mask),
                     lambda: tk.run_steps_planes_plain(chunks, mask),
                     f"n_steps={n_steps} B={B}")

    # K3: the two step-leaf slots of the n=2^11 proofs, w=32
    leaves = gl.from_u64(rand_gl(rng, (32, 2 * m)), dev)
    results["K3"] = (lambda: mk.hash_no_pad_planes(leaves),
                     lambda: mk.hash_no_pad_planes_plain(leaves),
                     f"w=32 N={2 * m}")

    out = {}
    for name, (kernel, plain, what) in results.items():
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0.0 or not torch.equal(got, want):
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"({what}): max_abs_err {err}")
        ms = cuda_ms(kernel, 5)
        plain_ms = cuda_ms(plain, 2)
        log(f"kernel {name} ({what}): equal to plain; {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return out


def fibonacci_shape(num_rows, degree_bits):
    """(stark, config, shape) of FibonacciStark under standard_fast_config."""
    fib = FibonacciStark(num_rows)
    config = StarkConfig.standard_fast_config()
    return fib, config, proof_shape(fib, config, degree_bits)


def tiled_fields(path, shape, size):
    """The fixture's fields as uint64 arrays, tiled up to `size` lanes."""
    fields = witness.u64_fields(witness.npz_leaves(path), shape)

    def tile(x):
        reps = -(-size // x.shape[0])
        return np.concatenate([x] * reps, axis=0)[:size].copy()

    return {k: (None if v is None else [tile(x) for x in v]
                if isinstance(v, list) else tile(v))
            for k, v in fields.items()}


def tamper(fields):
    """Corrupt one value in lanes 1..9 (lane 0 stays clean); returns the
    tampered fields and the lanes expected to fail."""
    f = {k: (None if v is None else [x.copy() for x in v]
             if isinstance(v, list) else v.copy())
         for k, v in fields.items()}

    def bump(arr, index):
        arr[index] = np.uint64((int(arr[index]) + 1) % gl.P)

    f["pow_witness"][1] ^= np.uint64(1)
    bump(f["trace_cap"], (2, 0, 0))
    bump(f["local_values"], (3, 0, 0))
    bump(f["public_inputs"], (4, 2))
    bump(f["initial_evals"][0], (5, 10, 1))
    bad = [1, 2, 3, 4, 5]
    if f["step_evals"]:
        bump(f["step_evals"][0], (6, 5, 3, 0))
        bump(f["commit_caps"][0], (7, 1, 0))
        bad += [6, 7]
    bump(f["final_poly"], (8, 0, 0))
    f["next_values"][9, 0, 0] = np.uint64(gl.P)   # not canonical
    bad += [8, 9]
    return f, bad


def drive(name, fib, config, shape, path, size, device_line):
    """Verify a real batch through the port's entry point on the card;
    returns the kernel launch counts of that run."""
    wrappers = {"K1": mk.verify_paths_planes, "K2": tk.run_steps_planes,
                "K3": mk.hash_no_pad_planes}
    fields = tiled_fields(path, shape, size)
    batch = witness.batch_from_u64(fields, shape, DEVICE)
    verify = build_verifier(fib, config, shape.degree_bits)

    for w in wrappers.values():
        w.launches = 0
    verdict = verify(batch)
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in wrappers.items()}
    if verdict.shape != (size,) or not bool(verdict.all()):
        raise AssertionError(f"{name}: valid proofs rejected: "
                             f"{int((~verdict).sum())} of {size}")
    expected = ["K1", "K2"] + (["K3"] if shape.reduction_arity_bits else [])
    for k in expected:
        if counts[k] < 1:
            raise AssertionError(f"{name}: kernel {k} never launched")
    log(f"{name}: {size} valid proofs verified; launches {counts}")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        verify(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    best = min(times)
    log(f"{name}: {size / best:.1f} proofs/s ({best * 1e3:.2f} ms per batch "
        f"of {size}, best of 3) on {device_line}")

    bad_fields, bad = tamper(fields)
    got = verify(witness.batch_from_u64(bad_fields, shape, DEVICE)).cpu()
    want = torch.ones(size, dtype=torch.bool)
    want[bad] = False
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: tampered verdicts {got[:16].tolist()}, "
                             f"expected {want[:16].tolist()}")
    cpu_fields = {k: (None if v is None else [x[:32] for x in v]
                      if isinstance(v, list) else v[:32])
                  for k, v in bad_fields.items()}
    cpu = verify(witness.batch_from_u64(cpu_fields, shape, "cpu"))
    if not torch.equal(cpu, got[:32]):
        raise AssertionError(f"{name}: card and CPU verdicts differ: "
                             f"{got[:32].tolist()} vs {cpu.tolist()}")
    log(f"{name}: tampered lanes {bad} rejected, lane 0 and the rest "
        "accepted; first 32 lanes equal the CPU plain path")
    return counts


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this test needs a CUDA card")

    # 1. the device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    device_line = smi.splitlines()[0]
    log(f"device: {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)

    # 2. build
    t0 = time.monotonic()
    built = _build.build_all()
    log(f"build: {time.monotonic() - t0:.1f} s for {sorted(built)}")
    for name, text in sorted(_build.build_log.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    # 3. each kernel against its plain version
    rng = np.random.default_rng(SEED)
    kstats = check_kernels(rng)

    # 4. the fold shape, n=2^11, B=1024: the main path
    fib, config, shape = fibonacci_shape(2048, 11)
    counts = drive("n=2^11 B=1024", fib, config, shape,
                   os.path.join(FIXTURES, "fib_stark_n2048_x32.npz"), 1024,
                   device_line)
    # 5. the flagship, n=2^5, B=4096
    fib, config, shape = fibonacci_shape(32, 5)
    counts_flagship = drive("n=2^5 B=4096", fib, config, shape,
                            os.path.join(FIXTURES, "fib_stark_n32_x32.npz"),
                            4096, device_line)

    # 6. the kernels line, then the contract's last line
    src = "halo2_plonky2_verifier_tpu_torch/ops/csrc/"
    meta = {
        "K1": ("merkle_path", src + "merkle_path.cu",
               "halo2_plonky2_verifier_tpu/ops/merkle_pallas.py:39"),
        "K2": ("transcript", src + "transcript.cu",
               "halo2_plonky2_verifier_tpu/ops/transcript_pallas.py:37"),
        "K3": ("leaf_sponge", src + "leaf_sponge.cu",
               "halo2_plonky2_verifier_tpu/ops/merkle_pallas.py:159"),
    }
    kernels = []
    for k, (name, source, replaces) in meta.items():
        kernels.append({
            "name": f"{k} {name}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[k],
            "launches_flagship": counts_flagship[k], "matched": True,
            **kstats[k]})
    print(json.dumps({"kernels": kernels, "card": device_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
