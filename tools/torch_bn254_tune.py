"""Launch shapes, designs and instruction census of the port's BN254 kernels
on a CUDA card: what bounds K4, K5 and K6 at a given register budget.

Three measurements, each on the card's own build (`ops/_build.py` flags):

  census  `cuobjdump -sass` of the K4, K5 and K6 libraries, as counts of
          each SASS opcode (how many instructions the carry chains of
          poseidon_bn254.cuh lower to);
  parent  with --parent, the kernels built from another commit's sources
          (K4, K5, K6 and K9's whole-permutation probes) beside the built
          ones, in turn (parent, built, built, parent), each checked equal
          to the built kernel: a change of the shared body A/B on one card;
  sweep   variants built from copies of the sources with text
          substitutions (`torch_gl_tune.build_variants`, one nvcc each, all
          at once): K5 in one thread a leaf at other (threads a block,
          minimum blocks an SM) and in four lanes a leaf (K6's
          permute_group4, the kernel inserted into the copy) at other
          launch bounds; K4 at other launch bounds and K6 at other threads
          a block.  Each variant's ptxas registers and spills, its time
          (`chip_smoke.cuda_ms`: the median of 5 launches between their own
          CUDA events) and whether its output equals the built kernel's, on
          chip_smoke's inputs (K5:
          seeded words at the drives' shapes, w = 4 at N = 86,016 and
          344,064, w = 32 at N = 172,032 and w = 2 at N = 688,128; K4: the
          BN254 n=2^11 slots, 430,080 paths of depth <= 8; K6: 4096 states).
          The built kernels are timed first and last.

Usage: python3 tools/torch_bn254_tune.py [--sweeps k4,k5,k6] [--parent DIR]
       [--out FILE]   (one CUDA card, nvcc, cuobjdump); DIR as for
tools/torch_gl_tune.py; FILE (default build/bn254_tune/tune.json) gets every
number.
"""

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

TOOLS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TOOLS)
sys.path.insert(0, REPO)
if TOOLS not in sys.path:
    sys.path.append(TOOLS)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import torch_bn254_micro  # noqa: E402
from torch_gl_tune import build_variants, parent_csrc, time_ab  # noqa: E402
from halo2_plonky2_verifier_tpu_torch.ops import _build  # noqa: E402
from halo2_plonky2_verifier_tpu_torch.ops import (  # noqa: E402
    bn254_kernels as bk, bn254_micro_kernels as mk9, goldilocks as gl)

OUT = os.path.join(REPO, "build", "bn254_tune")
# The text each sweep substitutes, as it stands in the built sources.
K4_SHAPE = ("constexpr int PATH_THREADS = 128;",
            "__launch_bounds__(PATH_THREADS, 4)")
K5_LAUNCH = """    if (w > 3)
      launch<256, 1>(in, out, w, n, (cudaStream_t)stream);
    else
      launch<128, 4>(in, out, w, n, (cudaStream_t)stream);"""
K5_ENTRY = 'extern "C" int launch_bn254_leaf('
# K5 over four lanes a leaf (K6's permute_group4), inserted into a copy of
# bn254_leaf.cu before its entry point: lanes 1-3 pack and convert their own
# triple of each chunk, lane 0 keeps the capacity, the group permutes; the
# tables go to shared memory as in K6.  A ragged N leaves the last group
# idle: it hashes a copy of leaf N - 1 and stores nothing.
K5_GROUP_KERNEL = """__device__ __forceinline__ void leaf_hash_group4(
    const uint64_t* in, int64_t stride, int w, int e, int base,
    const bn::OptTables& t, uint32_t x[bn::NL]) {
#pragma unroll
  for (int k = 0; k < bn::NL; ++k) x[k] = 0;
  for (int off = 0; off < w; off += 9) {
    const int lo = off + 3 * (e - 1);
    const int end = min(off + 9, w);
    if (e > 0 && lo < end)
      bn::pack_to_mont(in, stride, lo, min(lo + 3, end), x);
    bn::permute_group4(x, e, base, t);
  }
}

template <int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    bn254_leaf_group_kernel(const uint64_t* __restrict__ in,
                            uint64_t* __restrict__ out, int w, int64_t n) {
  __shared__ bn::OptTables tables;
  bn::copy_tables(tables, threadIdx.x, THREADS);
  __syncthreads();
  const int64_t leaf = (blockIdx.x * (int64_t)THREADS + threadIdx.x) / 4;
  const int e = threadIdx.x % 4;
  const int base = (threadIdx.x % 32) & ~3;
  const int64_t lane = leaf < n ? leaf : n - 1;
  uint32_t x[bn::NL];
  leaf_hash_group4(in + lane, n, w, e, base, tables, x);
  if (e == 0 && leaf < n) {
    bn::reduce(x, BN_P);
    bn::store(out + lane, n, x);
  }
}

template <int THREADS, int MIN_BLOCKS>
static void launch_group(const void* in, void* out, int w, long long n,
                         cudaStream_t stream) {
  const long long blocks = (n * 4 + THREADS - 1) / THREADS;
  bn254_leaf_group_kernel<THREADS, MIN_BLOCKS>
      <<<(unsigned)blocks, THREADS, 0, stream>>>(
          (const uint64_t*)in, (uint64_t*)out, w, (int64_t)n);
}

"""
K6_THREADS_LINE = "constexpr int PERMUTE_THREADS = 128;"

# K5 at the drives' shapes: (w, N)
K5_SHAPES = ((4, 86_016), (4, 344_064), (32, 172_032), (2, 688_128))


def k4_variant(t, b):
    return (f"k4_t{t}_b{b}", {"threads": t, "min_blocks": b},
            "bn254_path.cu", {"bn254_path.cu": [
                (K4_SHAPE[0], f"constexpr int PATH_THREADS = {t};"),
                (K4_SHAPE[1], f"__launch_bounds__(PATH_THREADS, {b})")]})


def k5_one_variant(t, b):
    """K5 in one thread a leaf at launch bounds (t, b) for every w."""
    return (f"k5_one_t{t}_b{b}", {"form": "one", "threads": t,
                                  "min_blocks": b},
            "bn254_leaf.cu", {"bn254_leaf.cu": [
                (K5_LAUNCH, f"    launch<{t}, {b}>(in, out, w, n, "
                            f"(cudaStream_t)stream);")]})


def k5_group_variant(t, b):
    """K5 in four lanes a leaf for w > 3 at launch bounds (t, b), one
    thread a leaf (as built) for w <= 3."""
    return (f"k5_group_t{t}_b{b}", {"form": "group4", "threads": t,
                                    "min_blocks": b},
            "bn254_leaf.cu", {"bn254_leaf.cu": [
                (K5_LAUNCH.split("\n")[1],
                 f"      launch_group<{t}, {b}>(in, out, w, n, "
                 f"(cudaStream_t)stream);"),
                (K5_ENTRY, K5_GROUP_KERNEL + K5_ENTRY)]})


def k6_variant(t):
    return (f"k6_t{t}", {"threads": t}, "bn254_permute.cu",
            {"bn254_permute.cu": [
                (K6_THREADS_LINE, f"constexpr int PERMUTE_THREADS = {t};")]})


K4_VARIANTS = [k4_variant(t, b) for t, b in (
    (256, 2), (64, 8), (128, 3), (128, 5))]
K5_VARIANTS = [k5_one_variant(t, b) for t, b in (
    (128, 4), (256, 2), (512, 1), (64, 8), (128, 3), (256, 1))] + [
        k5_group_variant(t, b) for t, b in ((128, 1), (128, 8))]
K6_VARIANTS = [k6_variant(t) for t in (64, 256)]
# kernel -> the source of its parent build
PARENT = {"K4": "bn254_path.cu", "K5": "bn254_leaf.cu",
          "K6": "bn254_permute.cu", "K9": "bn254_micro.cu"}


def census(name):
    """Counter of SASS opcodes in kernel `name`'s built library."""
    lib = _build.lib_path(name, _build.header_texts())
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    ops = collections.Counter()
    for line in sass.splitlines():
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if m:
            ops[m.group(1)] += 1
    return ops


def entry(lib, kernel):
    """The C entry point of `kernel`'s library `lib`, typed as the built
    one."""
    _, symbol, argtypes = _build.KERNELS[kernel]
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    return fn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(OUT, "tune.json"))
    ap.add_argument("--sweeps", default="k4,k5,k6",
                    help="comma-separated subset of k4,k5,k6")
    ap.add_argument("--parent", default=None,
                    help="directory of the sources to compare with")
    args = ap.parse_args()
    sweeps = set(args.sweeps.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("torch_bn254_tune: no CUDA card")
    os.makedirs(OUT, exist_ok=True)
    _build.build_all()
    report = {"card": cs.torch_sol_bench.card_line(), "census": {},
              "built": [], "parent": [], "k4": [], "k5": [], "k6": []}
    print(f"device: {report['card']}", flush=True)
    for name in ("bn254_path", "bn254_leaf", "bn254_permute"):
        ops = census(name)
        report["census"][name] = dict(ops)
        print(f"census {name}: {sum(ops.values())} instructions; "
              f"{ops.most_common(12)}", flush=True)
    variants = ((K4_VARIANTS if "k4" in sweeps else [])
                + (K5_VARIANTS if "k5" in sweeps else [])
                + (K6_VARIANTS if "k6" in sweeps else []))
    if args.parent:
        variants += [(f"parent_{k}", {"parent": args.parent}, src, {},
                      parent_csrc(args.parent)) for k, src in PARENT.items()]
    built = build_variants(variants, out=OUT)
    for tag, (_, ptxas) in built.items():
        print(f"ptxas {tag}: {ptxas}", flush=True)

    rng = np.random.default_rng(cs.SEED)
    node, sib, idx, active = cs.path_inputs(
        rng, (8, 8, 8, 4, 0), 1024 * 84, lambda n: cs.rand_fr(rng, (n,)),
        lambda d, n: cs.rand_fr(rng, (d, n)))
    states = gl.from_u64(
        cs.rand_fr(rng, (4096, 4)).reshape(4096, 16).T.copy(), cs.DEVICE)
    leaves = [gl.from_u64(cs.rand_gl(rng, (w, n)), cs.DEVICE)
              for w, n in K5_SHAPES]
    probe = torch_bn254_micro.probe_input(
        "permute", torch_bn254_micro.LANES, rng, cs.DEVICE)
    want4 = bk.verify_paths_mont_planes(node, sib, idx, active)
    want5 = [bk.hash_or_noop_mont_planes(x) for x in leaves]
    want6 = bk.permute_planes(states)
    chain9 = torch_bn254_micro.CHAIN
    want9 = {t: mk9.run_probe("permute", probe, chain9, t)
             for t in (128, 256, 512)}
    stream = torch.cuda.current_stream().cuda_stream

    def k4(fn):
        out = torch.empty_like(node)
        return out, lambda: fn(node.data_ptr(), sib.data_ptr(),
                               idx.data_ptr(), active.data_ptr(),
                               out.data_ptr(), node.shape[1],
                               sib.shape[0], stream)

    def k5(fn, x):
        out = torch.empty((4, x.shape[1]), dtype=torch.int64,
                          device=x.device)
        return out, lambda: fn(x.data_ptr(), out.data_ptr(), x.shape[0],
                               x.shape[1], stream)

    def k6(fn):
        out = torch.empty_like(states)
        return out, lambda: fn(states.data_ptr(), out.data_ptr(),
                               states.shape[1], stream)

    def k9(fn, t):
        out = torch.empty_like(probe)
        return out, lambda: fn(probe.data_ptr(), out.data_ptr(),
                               mk9.PROBES["permute"][0], chain9,
                               probe.shape[1], t, stream)

    def time_built():
        row = {"K4": cs.cuda_ms(
            lambda: bk.verify_paths_mont_planes(node, sib, idx, active), 5),
            "K6": cs.cuda_ms(lambda: bk.permute_planes(states), 5)}
        for (w, n), x in zip(K5_SHAPES, leaves):
            row[f"K5 w={w} N={n}"] = cs.cuda_ms(
                lambda x=x: bk.hash_or_noop_mont_planes(x), 5)
        report["built"].append(row)
        print(f"built: {row}", flush=True)

    def parent_ab():
        """Each parent build beside the built kernel, in turn."""
        cases = [("K4", "bn254_path", k4, (), want4,
                  lambda: bk.verify_paths_mont_planes(node, sib, idx,
                                                      active)),
                 ("K6", "bn254_permute", k6, (), want6,
                  lambda: bk.permute_planes(states))]
        cases += [(f"K5 w={w} N={n}", "bn254_leaf", k5, (x,), want,
                   lambda x=x: bk.hash_or_noop_mont_planes(x))
                  for (w, n), x, want in zip(K5_SHAPES, leaves, want5)]
        cases += [(f"K9 permute threads={t}", "bn254_micro", k9, (t,),
                   want9[t], lambda t=t: mk9.run_probe("permute", probe,
                                                       chain9, t))
                  for t in (128, 256, 512)]
        for label, kernel, make, extra, want, built_call in cases:
            lib, ptxas = built[f"parent_{label.split()[0]}"]
            out, call = make(entry(lib, kernel), *extra)
            times = time_ab(("parent", call), ("built", built_call))
            row = {"kernel": label, **times,
                   "equal": bool(torch.equal(out, want)), "ptxas": ptxas}
            report["parent"].append(row)
            print(f"parent {row}", flush=True)

    time_built()
    if args.parent:
        parent_ab()
    for tag, params, _, _ in K5_VARIANTS if "k5" in sweeps else ():
        lib, ptxas = built[tag]
        fn = entry(lib, "bn254_leaf")
        row = {"tag": tag, **params, "ptxas": ptxas}
        for (w, n), x, want in zip(K5_SHAPES, leaves, want5):
            out, call = k5(fn, x)
            row[f"ms w={w} N={n}"] = cs.cuda_ms(call, 5)
            row[f"equal w={w} N={n}"] = bool(torch.equal(out, want))
        report["k5"].append(row)
        print(f"K5 {row}", flush=True)
    for tag, params, _, _ in K4_VARIANTS if "k4" in sweeps else ():
        lib, ptxas = built[tag]
        out, call = k4(entry(lib, "bn254_path"))
        row = {"tag": tag, **params, "ms": cs.cuda_ms(call, 5),
               "equal": bool(torch.equal(out, want4)), "ptxas": ptxas}
        report["k4"].append(row)
        print(f"K4 {row}", flush=True)
    for tag, params, _, _ in K6_VARIANTS if "k6" in sweeps else ():
        lib, ptxas = built[tag]
        out, call = k6(entry(lib, "bn254_permute"))
        row = {"tag": tag, **params, "ms": cs.cuda_ms(call, 5),
               "equal": bool(torch.equal(out, want6)), "ptxas": ptxas}
        report["k6"].append(row)
        print(f"K6 {row}", flush=True)
    time_built()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
