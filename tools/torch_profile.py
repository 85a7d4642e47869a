"""Where the time goes in one verify of the PyTorch port, on a CUDA card.

For each drive of `chip_smoke.py` (FibonacciStark n=2^11 B=1024 and n=2^5
B=4096 under Goldilocks caps and transcript; the same two sizes under BN254
caps with the Goldilocks transcript; n=2^5 B=4096 all-BN254; the PLONK
recmix circuit at B=4096, read from JSON; PlonkishStark n=2^11 B=1024 and
n=2^5 B=4096, read from JSON), this builds
the kernels, times three warm `verify(batch)` calls without the profiler,
then traces one more under `torch.profiler` (CPU and CUDA activities) and
writes:

  <out>/profile_summary.json   per size: best unprofiled wall ms, profiled
                               wall ms, device busy ms (sum of the traced
                               device kernels' durations), device kernel
                               launches, aten ops, cudaLaunchKernel calls and
                               their host ms, idle share (1 - busy / best
                               unprofiled wall), and busy ms and launches
                               grouped by kernel;
  <out>/profile_<size>.txt     the profiler's key_averages tables, sorted by
                               device time and by host time.

With --census (on the CPU; no card) it instead counts the PLONK drives'
launches: one verify's aten ops less views, each kernel one launch, and
those of its vanishing terms at zeta (<out>/plonk_census.json); and the
plonkish drives' launches, one verify of one proof at n=2^11 and at n=2^5
(<out>/plonkish_census.json).  The same verify takes the op census
(`utils/profiling.py`), which launches nothing: for each drive
<out>/op_census_<tag>.txt (the nested report of every metric),
op_census_<tag>.folded (collapsed gl_mul stacks) and op_census_<tag>.svg
(the gl_mul flamegraph).

With --clock-probe it instead asks why K4 and K5 take less time inside a
verify than back to back (as `chip_smoke.py` times them).  On the BN254
n=2^11 B=1024 drive it times every K4 and K5 launch of three verifies with
CUDA events, then runs each of them four times back to back, on random
inputs made as `chip_smoke.py` makes them and on the inputs captured from
the verify, and twice more alone after an idle second.  `nvidia-smi`
samples the SM clock, power draw and temperature every 20 ms throughout;
<out>/clock_probe.json holds each window's launch times and samples.

Usage: python3 tools/torch_profile.py [--out DIR] [--drives TAGS]
       [--census] [--clock-probe] (default DIR build/torch_profile; TAGS a
       comma-separated subset such as plonk_recmix_s60_B4096 or
       plonkish_n2048_B1024,plonkish_n32_B4096).  Needs one
       CUDA card and nvcc; imports no jax.
"""

import argparse
import json
import os
import statistics
import sys
import time
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import numpy as np  # noqa: E402

from chip_smoke import (BN, FIXTURES, GLH, LOGUP, RECMIX,  # noqa: E402
                        RECURSIVE_FIB, SEED, fibonacci_shape, path_inputs,
                        plonk_fields, plonkish_fields, rand_fr, rand_gl,
                        tiled_fields)
from halo2_plonky2_verifier_tpu_torch import (build_verifier,  # noqa: E402
                                              hashing, plonk, witness)
from halo2_plonky2_verifier_tpu_torch.ops import _build  # noqa: E402
from halo2_plonky2_verifier_tpu_torch.ops import goldilocks as gl  # noqa: E402
from halo2_plonky2_verifier_tpu_torch.utils import profiling  # noqa: E402
from halo2_plonky2_verifier_tpu_torch.utils.timing import (  # noqa: E402
    SmiSampler)

SIZES = (
    # tag, n, degree_bits, fixture, B, hasher, transcript
    ("n2048_B1024", 2048, 11, "fib_stark_n2048_x32.npz", 1024, GLH, GLH),
    ("n32_B4096", 32, 5, "fib_stark_n32_x32.npz", 4096, GLH, GLH),
    ("bn254_n2048_B1024", 2048, 11, "fib_stark_n2048_poseidon_bn254_x8.npz",
     1024, BN, GLH),
    ("bn254_n32_B4096", 32, 5, "fib_stark_n32_poseidon_bn254_x32.npz", 4096,
     BN, GLH),
    ("allbn254_n32_B4096", 32, 5,
     "fib_stark_n32_poseidon_bn254_bn254sponge_x8.npz", 4096, BN, BN),
)
# tag, circuit, B: the PLONK recmix drive of chip_smoke.py
PLONK_SIZES = (("plonk_recmix_s60_B4096", RECMIX, 4096),)
# tag, n, degree_bits, proofs file, B: the plonkish drives of chip_smoke.py
PLONKISH_SIZES = (
    ("plonkish_n2048_B1024", 2048, 11, "plonkish_n2048_x8.jsonl", 1024),
    ("plonkish_n32_B4096", 32, 5, "plonkish_n32_x8.jsonl", 4096),
)
PORT_KERNELS = ("merkle_path_kernel", "transcript_kernel",
                "leaf_sponge_kernel", "bn254_path_kernel", "bn254_leaf_kernel",
                "bn254_permute_kernel", "permute_kernel")


def kernel_group(name):
    name = name.removeprefix("void ")  # a template kernel's traced name
    for k in PORT_KERNELS:
        if name.startswith(k):
            return k
    if name.startswith(("Memcpy", "Memset")):
        return "memcpy/memset"
    return "aten elementwise/index/other"


def profile_size(num_rows, degree_bits, fixture, size, hasher, transcript):
    fib, config, shape = fibonacci_shape(num_rows, degree_bits, hasher)
    fields = tiled_fields(os.path.join(FIXTURES, fixture), shape, size)
    batch = witness.batch_from_u64(fields, shape, "cuda")
    verify = build_verifier(fib, config, degree_bits, hasher=hasher,
                            transcript=transcript)
    return profile_verify(verify, batch, f"n={num_rows} B={size}")


def plonkish_batch(num_rows, degree_bits, proofs_file, size, device):
    """(verify, batch) of a plonkish drive of `chip_smoke.py`, on
    `device`."""
    stark_, config, shape, fields = plonkish_fields(num_rows, degree_bits,
                                                    proofs_file, size)
    return (build_verifier(stark_, config, degree_bits),
            witness.batch_from_u64(fields, shape, device))


def profile_plonkish(num_rows, degree_bits, proofs_file, size):
    verify, batch = plonkish_batch(num_rows, degree_bits, proofs_file, size,
                                   "cuda")
    return profile_verify(verify, batch, f"plonkish n={num_rows} B={size}")


def profile_plonk(circuit, size):
    common, vd, shape, fields = plonk_fields(circuit, size)
    batch = plonk.plonk_batch_from_u64(fields, shape, "cuda")
    return profile_verify(plonk.build_plonk_verifier(common, vd), batch,
                          f"PLONK {circuit[0]} B={size}")


def profile_verify(verify, batch, what):
    if not bool(verify(batch).all()):
        raise AssertionError(f"{what}: valid proofs rejected")
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
        # a census scope (`utils/profiling.py:scope`) shows on the device as
        # a user annotation spanning its kernels: no device work of its own
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
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


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def clock_probe(out):
    """See the module docstring (--clock-probe)."""
    with SmiSampler(os.path.join(out, "clock_probe_smi.csv"),
                    start_s=0) as sampler:
        windows = _clock_probe_windows()
    samples = sampler.samples()
    for w in windows:
        inside = [r for r in samples if w["t0"] <= r[0] <= w["t1"]]
        w["smi_samples"] = len(inside)
        if inside:
            clk = [r[1] for r in inside]
            w["sm_mhz_min_median_max"] = [min(clk), statistics.median(clk),
                                          max(clk)]
            w["power_w_max"] = max(r[2] for r in inside)
            w["temp_c_max"] = max(r[3] for r in inside)
    result = {"windows": windows, "smi_samples_total": len(samples)}
    with open(os.path.join(out, "clock_probe.json"), "w") as f:
        json.dump(result, f, indent=1)
    for w in windows:
        print(json.dumps({k: v for k, v in w.items()
                          if k not in ("t0", "t1")}), flush=True)


def _clock_probe_windows():
    fib, config, shape = fibonacci_shape(2048, 11, BN)
    fields = tiled_fields(os.path.join(
        FIXTURES, "fib_stark_n2048_poseidon_bn254_x8.npz"), shape, 1024)
    batch = witness.batch_from_u64(fields, shape, "cuda")
    verify = build_verifier(fib, config, 11, hasher=BN, transcript=GLH)
    H = hashing.BN254HashOps
    k4, k5 = H.verify_paths, H.leaf_hash
    launches, captured, windows = [], {}, []

    def timed(kernel, name_of):
        def run(*args):
            tag = name_of(args)
            captured.setdefault(tag, [a.clone() for a in args])
            start, end = _events()
            start.record()
            res = kernel(*args)
            end.record()
            launches.append((tag, start, end))
            return res
        return staticmethod(run)

    def window(tag, fn):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        windows.append({"window": tag, "t0": t0, "t1": time.time(),
                        "wall_ms": (time.time() - t0) * 1e3})
        return windows[-1]

    def launches_ms():
        torch.cuda.synchronize()
        out = defaultdict(list)
        for tag, start, end in launches:
            out[tag].append(start.elapsed_time(end))
        launches.clear()
        return dict(out)

    H.verify_paths = timed(k4, lambda a: "K4")
    H.leaf_hash = timed(k5, lambda a: f"K5 w={a[0].shape[0]}")
    try:
        window("warm-up verify", lambda: verify(batch))
        launches_ms()
        time.sleep(2)
        for i in range(3):
            w = window(f"verify {i}", lambda: verify(batch))
            w["launch_ms"] = launches_ms()
    finally:
        H.verify_paths, H.leaf_hash = staticmethod(k4), staticmethod(k5)

    rng = np.random.default_rng(SEED)
    m = 1024 * 84
    rand = {"K4": path_inputs(rng, (8, 8, 8, 4, 0), m,
                              lambda n: rand_fr(rng, (n,)),
                              lambda d, n: rand_fr(rng, (d, n))),
            "K5 w=32": (gl.from_u64(rand_gl(rng, (32, 2 * m)), "cuda"),)}
    runs = [("random", tag, args) for tag, args in rand.items()]
    runs += [("from the verify", tag, args)
             for tag, args in sorted(captured.items())]
    for mode, tag, args in runs:
        kernel = k4 if tag == "K4" else k5
        ms = []

        def back_to_back():
            for _ in range(4):
                start, end = _events()
                start.record()
                kernel(*args)
                end.record()
                ms.append((start, end))

        time.sleep(2)
        w = window(f"{tag} {mode}, 4 back to back", back_to_back)
        w["launch_ms"] = [s.elapsed_time(e) for s, e in ms]
        if tag == "K4":
            w["active_levels"] = int(args[3].sum())
            w["lanes"] = int(args[0].shape[1])
        for i in range(2):
            ms.clear()
            time.sleep(1)
            w = window(f"{tag} {mode}, alone after 1 s idle ({i})",
                       lambda: ms.append(_timed_once(kernel, args)))
            w["launch_ms"] = [ms[0]]
    return windows


def _timed_once(kernel, args):
    start, end = _events()
    start.record()
    kernel(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


# ops that make a view and launch nothing on the card
_VIEW_OPS = {"aten.view.default", "aten._unsafe_view.default",
             "aten.select.int", "aten.slice.Tensor", "aten.expand.default",
             "aten.unsqueeze.default", "aten.squeeze.dim", "aten.t.default",
             "aten.transpose.int", "aten.permute.default", "aten.alias.default",
             "aten.detach.default", "aten.as_strided.default",
             "aten.lift_fresh.default", "aten.unbind.int", "aten.split.Tensor"}


class _LaunchCount(TorchDispatchMode):
    """Counts the aten ops that would launch a kernel on the card; a
    wrapper of `_KERNELS` counts as one launch, its plain body as none.  The
    profiler's ops (`record_function`'s markers, which the census scopes of
    `utils/profiling.py` enter) launch nothing and are not counted."""

    def __init__(self):
        super().__init__()
        self.n = 0
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if not (self.paused or name in _VIEW_OPS
                or name.startswith("profiler.")):
            self.n += 1
        return func(*args, **(kwargs or {}))

    def kernel(self, fn):
        def run(*a, **k):
            self.paused = True
            try:
                return fn(*a, **k)
            finally:
                self.paused = False
                self.n += 1
        return run


def write_op_census(out, tag, tree):
    """The op census of one verify: <out>/op_census_<tag>.txt (the report
    of every metric it counted), .folded and .svg (gl_mul)."""
    metrics = [m for m in ("gl_mul", "gl_add", "poseidon_permute",
                           "bn254_mont_mul", "poseidon_bn254_permute")
               if tree.root.total(m)]
    base = os.path.join(out, f"op_census_{tag}")
    with open(base + ".txt", "w") as f:
        for m in metrics:
            f.write(f"== {m} ==\n{tree.report(m)}\n\n")
    tree.write_collapsed(base + ".folded")
    tree.write_flamegraph_svg(base + ".svg", title=f"{tag}: gl_mul")
    return {m: tree.root.total(m) for m in metrics}


def _counted_verify(counter, verify, batch):
    """verify(batch) under `counter` and an op census, each of K1, K2, K3
    and K7 counted as one launch.  Returns (verdict, census tree)."""
    from halo2_plonky2_verifier_tpu_torch import transcript
    from halo2_plonky2_verifier_tpu_torch.ops import (merkle_kernels,
                                                      poseidon_kernels)

    patched = [(hashing.GLHashOps, "verify_paths"),
               (merkle_kernels, "hash_no_pad_planes"),
               (transcript.transcript_kernels, "run_steps_planes"),
               (poseidon_kernels, "permute_planes")]
    saved = [getattr(o, a) for o, a in patched]
    for (o, a), fn in zip(patched, saved):
        setattr(o, a, staticmethod(counter.kernel(fn))
                if isinstance(o, type) else counter.kernel(fn))
    try:
        with counter, profiling.profile() as tree:
            return verify(batch), tree
    finally:
        for (o, a), fn in zip(patched, saved):
            setattr(o, a, staticmethod(fn) if isinstance(o, type) else fn)


def census(out):
    """The launch model on the CPU (aten ops less views, each of K1, K2, K3
    and K7 counted as one launch).  PLONK drives: per circuit, the
    launches of one `build_plonk_verifier` verify, and those of its
    vanishing terms at zeta (`circuit/vanishing.py:eval_vanishing_terms`)
    among them (plonk_census.json).  Plonkish drives: the launches of one
    `build_verifier` verify of one proof at each size
    (plonkish_census.json)."""
    result = {}
    for tag, circuit in (("plonk_recmix_s60", RECMIX),
                         ("recursive_fib_n8", RECURSIVE_FIB),
                         ("logup", LOGUP)):
        common, vd, shape, fields = plonk_fields(circuit, 1)
        batch = plonk.plonk_batch_from_u64(fields, shape, "cpu")
        counter = _LaunchCount()
        vanishing = []
        eval_vanishing = plonk.eval_vanishing_terms

        def counted_vanishing(*a, **k):
            n0 = counter.n
            out = eval_vanishing(*a, **k)
            vanishing.append(counter.n - n0)
            return out

        plonk.eval_vanishing_terms = counted_vanishing
        try:
            ok, tree = _counted_verify(counter, plonk.build_plonk_verifier(
                common, vd), batch)
        finally:
            plonk.eval_vanishing_terms = eval_vanishing
        if not bool(ok.all()):
            raise AssertionError(f"census {tag}: the proof was rejected")
        result[tag] = {"verify_launches": counter.n,
                       "vanishing_launches": vanishing[0],
                       "op_census": write_op_census(out, tag, tree)}
        print(tag, json.dumps(result[tag]), flush=True)
    with open(os.path.join(out, "plonk_census.json"), "w") as f:
        json.dump(result, f, indent=1)

    result = {}
    for tag, num_rows, degree_bits, proofs_file, _ in PLONKISH_SIZES:
        verify, batch = plonkish_batch(num_rows, degree_bits, proofs_file, 1,
                                       "cpu")
        counter = _LaunchCount()
        ok, tree = _counted_verify(counter, verify, batch)
        if not bool(ok.all()):
            raise AssertionError(f"census {tag}: the proof was rejected")
        result[tag] = {"verify_launches": counter.n,
                       "op_census": write_op_census(out, tag, tree)}
        print(tag, json.dumps(result[tag]), flush=True)
    with open(os.path.join(out, "plonkish_census.json"), "w") as f:
        json.dump(result, f, indent=1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "torch_profile"))
    ap.add_argument("--drives", default="",
                    help="comma-separated tags to profile (default: all)")
    ap.add_argument("--clock-probe", action="store_true",
                    help="time K4 and K5 inside a verify and back to back, "
                         "with SM clock and power samples")
    ap.add_argument("--census", action="store_true",
                    help="on the CPU, no card needed: the PLONK drives' "
                         "launch model (plonk_census.json)")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    if args.census:
        census(args.out)
        return
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile: needs a CUDA card")
    _build.build_all()
    if args.clock_probe:
        clock_probe(args.out)
        return

    runs = [(tag, profile_size, spec) for tag, *spec in SIZES]
    runs += [(tag, profile_plonk, spec) for tag, *spec in PLONK_SIZES]
    runs += [(tag, profile_plonkish, spec) for tag, *spec in PLONKISH_SIZES]
    if args.drives:
        runs = [r for r in runs if r[0] in args.drives.split(",")]
    summaries = {}
    for tag, fn, spec in runs:
        summary, table = fn(*spec)
        summaries[tag] = summary
        with open(os.path.join(args.out, f"profile_{tag}.txt"), "w") as f:
            f.write(table + "\n")
        print(tag, json.dumps(summary), flush=True)
    with open(os.path.join(args.out, "profile_summary.json"), "w") as f:
        json.dump(summaries, f, indent=1)


if __name__ == "__main__":
    main()
