"""Where the time goes in one verify of the PyTorch port, on a CUDA card.

For each size of the main path (FibonacciStark n=2^11 B=1024 and n=2^5
B=4096, the batches of `chip_smoke.py`), this builds the kernels, times
three warm `verify(batch)` calls without the profiler, then traces one more
under `torch.profiler` (CPU and CUDA activities) and writes:

  <out>/profile_summary.json   per size: best unprofiled wall ms, profiled
                               wall ms, device busy ms (sum of the traced
                               device kernels' durations), device kernel
                               launches, aten ops, cudaLaunchKernel calls and
                               their host ms, idle share (1 - busy / best
                               unprofiled wall), and busy ms and launches
                               grouped by kernel;
  <out>/profile_<size>.txt     the profiler's key_averages tables, sorted by
                               device time and by host time.

Usage: python3 tools/torch_profile.py [--out DIR]   (default build/torch_profile)
Needs one CUDA card and nvcc; imports no jax.
"""

import argparse
import json
import os
import sys
import time
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import FIXTURES, fibonacci_shape, tiled_fields  # noqa: E402
from halo2_plonky2_verifier_tpu_torch import build_verifier, witness  # noqa: E402
from halo2_plonky2_verifier_tpu_torch.ops import _build  # noqa: E402

SIZES = (
    ("n2048_B1024", 2048, 11, "fib_stark_n2048_x32.npz", 1024),
    ("n32_B4096", 32, 5, "fib_stark_n32_x32.npz", 4096),
)
PORT_KERNELS = ("merkle_path_kernel", "transcript_kernel",
                "leaf_sponge_kernel")


def kernel_group(name):
    for k in PORT_KERNELS:
        if name.startswith(k):
            return k
    if name.startswith(("Memcpy", "Memset")):
        return "memcpy/memset"
    return "aten elementwise/index/other"


def profile_size(num_rows, degree_bits, fixture, size):
    fib, config, shape = fibonacci_shape(num_rows, degree_bits)
    fields = tiled_fields(os.path.join(FIXTURES, fixture), shape, size)
    batch = witness.batch_from_u64(fields, shape, "cuda")
    verify = build_verifier(fib, config, degree_bits)

    if not bool(verify(batch).all()):
        raise AssertionError(f"n={num_rows} B={size}: valid proofs rejected")
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        verify(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        verify(batch)
        torch.cuda.synchronize()
        profiled = time.perf_counter() - t0

    busy_us = 0.0
    group_us, group_n = defaultdict(float), defaultdict(int)
    aten_ops = launch_calls = 0
    launch_us = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy_us += us
            g = kernel_group(e.name)
            group_us[g] += us
            group_n[g] += 1
        elif e.name.startswith("aten::"):
            aten_ops += 1
        elif e.name == "cudaLaunchKernel":
            launch_calls += 1
            launch_us += e.time_range.elapsed_us()
    best = min(walls)
    summary = {
        "wall_ms_best_of_3": best * 1e3,
        "wall_ms_profiled": profiled * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_launches": sum(group_n.values()),
        "aten_ops": aten_ops,
        "cudaLaunchKernel_calls": launch_calls,
        "cudaLaunchKernel_host_ms": launch_us / 1e3,
        "idle_share_unprofiled": 1.0 - busy_us / 1e3 / (best * 1e3),
        "by_group_ms": {g: v / 1e3 for g, v in group_us.items()},
        "by_group_launches": dict(group_n),
    }
    table = "\n\n".join(
        prof.key_averages().table(sort_by=key, row_limit=40)
        for key in ("self_device_time_total", "self_cpu_time_total"))
    return summary, table


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "torch_profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile: needs a CUDA card")
    os.makedirs(args.out, exist_ok=True)
    _build.build_all()

    summaries = {}
    for tag, num_rows, degree_bits, fixture, size in SIZES:
        summary, table = profile_size(num_rows, degree_bits, fixture, size)
        summaries[tag] = summary
        with open(os.path.join(args.out, f"profile_{tag}.txt"), "w") as f:
            f.write(table + "\n")
        print(tag, json.dumps(summary), flush=True)
    with open(os.path.join(args.out, "profile_summary.json"), "w") as f:
        json.dump(summaries, f, indent=1)


if __name__ == "__main__":
    main()
