"""Launch shapes, designs and instruction census of the port's BN254 kernels
on a CUDA card: what bounds K4, K5, K6 and K9 at a given register budget.

Four measurements, each on the card's own build (`ops/_build.py` flags):

  census  `cuobjdump -sass` of the K4, K5 and K6 libraries, as counts of
          each SASS opcode (how many instructions the carry chains of
          poseidon_bn254.cuh lower to); with --parent, whether each one's
          SASS equals the parent build's (`sass_equal_parent`);
  k9      K9's SASS split by function, one template instance a probe run
          of `tools/torch_bn254_micro.py`: for each run its wide products
          (IMAD.WIDE.U32), carries (IADD3, IADD3.X), moves and zeroings
          (MOV, IMAD.MOV.U32, HFMA2.MMA) and selects (SEL), beside its time
          (`torch_bn254_micro.measure`);
  parent  with --parent, the kernels built from another commit's sources
          (K4, K5, K6, and K9's permutation and squaring probes where the
          parent's K9 has this one's interface) beside the built ones, in
          turn (parent, built, built, parent), each checked equal to the
          built kernel: a change of the shared body A/B on one card;
  sweep   variants built from copies of the sources with text
          substitutions (`torch_gl_tune.build_variants`, one nvcc each, all
          at once): K5 in one thread a leaf at other (threads a block,
          minimum blocks an SM) and in four lanes a leaf (K6's
          permute_group4, the kernel inserted into the copy) at other
          launch bounds; K4 at other launch bounds and K6 at other threads
          a block (`k4`, `k5`, `k6`); K4 and K9's permutation probe on the
          body with the permutation's full and partial rounds in loops of
          their own (`body`, each timed in turn beside the built kernel).  Each variant's ptxas registers and spills, its time
          (`utils/timing.py:cuda_ms`: the median of 5 launches between
          their own CUDA events) and whether its output equals the built
          kernel's, on chip_smoke's inputs (K5: seeded words at the drives'
          shapes, w = 4 at N = 86,016 and 344,064, w = 32 at N = 172,032
          and w = 2 at N = 688,128; K4: the BN254 n=2^11 slots, 430,080
          paths of depth <= 8; K6: 4096 states; K9: 2^16 lanes, chain 64).
          The built kernels are timed first and last.

Usage: python3 tools/torch_bn254_tune.py [--sweeps k4,k5,k6,k9,body]
       [--parent DIR] [--out FILE]   (one CUDA card, nvcc, cuobjdump); DIR
as for tools/torch_gl_tune.py; FILE (default build/bn254_tune/tune.json)
gets every number.
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
from torch_gl_tune import (build_variants, parent_csrc,  # noqa: E402
                           time_ab, census as gl_census)
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

# The body's permutation loop, as it stands in poseidon_bn254.cuh, and two
# other forms of it: the full and the partial rounds in loops of their own
# (no branch in a round's loop; each round's code still once), and the
# same with the partial loop unrolled by two.
PERMUTE_LOOP = """#pragma unroll 1
  for (int r = 0; r < ROUNDS; ++r) {
    if (r < H || r >= H + BN_PARTIAL_ROUNDS)
      full_round(s, r < H ? r : r - BN_PARTIAL_ROUNDS);
    else
      partial_round(s, r - H);
  }"""
PERMUTE_LOOPS = """#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
#pragma unroll 1
    for (int r = 0; r < H; ++r) full_round(s, h * H + r);
    if (h == 1) break;
#pragma unroll UNROLL
    for (int i = 0; i < BN_PARTIAL_ROUNDS; ++i) partial_round(s, i);
  }"""


def body_variant(kernel, unroll):
    """K4 or K9 on the body with the permutation in its loops form."""
    source = {"k4": "bn254_path.cu", "k9": "bn254_micro.cu"}[kernel]
    return (f"body_loops_u{unroll}_{kernel}", {"unroll": unroll}, source,
            {"poseidon_bn254.cuh": [
                (PERMUTE_LOOP,
                 PERMUTE_LOOPS.replace("UNROLL", str(unroll)))]})


BODY_VARIANTS = [body_variant(k, u) for u in (1, 2) for k in ("k4", "k9")]

# The opcodes the k9 census reports a probe by.
K9_OPCODES = ("IMAD.WIDE.U32", "IADD3", "IADD3.X", "MOV", "IMAD.MOV.U32",
              "HFMA2.MMA", "SEL")


def sass_text(lib):
    """`cuobjdump -sass` of the library `lib`."""
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.find_nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout


def function_census(sass):
    """{function: Counter of its SASS opcodes} of `cuobjdump -sass` text;
    a function is named as `torch_bn254_micro.instance` names its mangled
    symbol (the symbol itself where that gives None)."""
    out, ops = {}, None
    for line in sass.splitlines():
        f = re.match(r"\s*Function : (\S+)", line)
        if f:
            name = torch_bn254_micro.instance(f.group(1)) or f.group(1)
            ops = out.setdefault(name, collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if m and ops is not None:
            ops[m.group(1)] += 1
    return out


def census(name):
    """Counter of SASS opcodes in kernel `name`'s built library."""
    return sum(function_census(sass_text(_build.lib_path(
        name, _build.header_texts()))).values(), collections.Counter())


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
    ap.add_argument("--sweeps", default="k4,k5,k6,k9,body",
                    help="comma-separated subset of k4,k5,k6,k9,body")
    ap.add_argument("--parent", default=None,
                    help="directory of the sources to compare with")
    args = ap.parse_args()
    sweeps = set(args.sweeps.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("torch_bn254_tune: no CUDA card")
    os.makedirs(OUT, exist_ok=True)
    _build.build_all()
    report = {"card": cs.torch_sol_bench.card_line(), "census": {},
              "built": [], "parent": [], "k4": [], "k5": [], "k6": [],
              "k9": [], "body": []}
    print(f"device: {report['card']}", flush=True)
    for name in BODY_KERNELS:
        ops = census(name)
        report["census"][name] = {"ops": dict(ops)}
        print(f"census {name}: {sum(ops.values())} instructions; "
              f"{ops.most_common(12)}", flush=True)
    variants = ((K4_VARIANTS if "k4" in sweeps else [])
                + (K5_VARIANTS if "k5" in sweeps else [])
                + (K6_VARIANTS if "k6" in sweeps else [])
                + (BODY_VARIANTS if "body" in sweeps else []))
    if args.parent:
        variants += [(f"parent_{k}", {"parent": args.parent}, src, {},
                      parent_csrc(args.parent)) for k, src in PARENT.items()]
    built = build_variants(variants, out=OUT)
    for tag, (_, ptxas) in built.items():
        print(f"ptxas {tag}: {ptxas}", flush=True)
    texts = _build.header_texts()
    for name in BODY_KERNELS if args.parent else ():
        tag = {v: k for k, v in PARENT.items()}[_build.KERNELS[name][0]]
        lib = os.path.join(OUT, f"parent_{tag}", f"libparent_{tag}.so")
        same = gl_census(lib)[2] == gl_census(_build.lib_path(name,
                                                              texts))[2]
        report["census"][name]["sass_equal_parent"] = same
        print(f"census {name}: SASS equal to the parent's: {same}",
              flush=True)

    rng = np.random.default_rng(cs.SEED)
    node, sib, idx, active = cs.path_inputs(
        rng, (8, 8, 8, 4, 0), 1024 * 84, lambda n: cs.rand_fr(rng, (n,)),
        lambda d, n: cs.rand_fr(rng, (d, n)))
    states = gl.from_u64(
        cs.rand_fr(rng, (4096, 4)).reshape(4096, 16).T.copy(), cs.DEVICE)
    leaves = [gl.from_u64(cs.rand_gl(rng, (w, n)), cs.DEVICE)
              for w, n in K5_SHAPES]
    probes9 = {name: torch_bn254_micro.probe_input(
        name, torch_bn254_micro.LANES, rng, cs.DEVICE)
        for name in ("permute", "sqr_redc")}
    want4 = bk.verify_paths_mont_planes(node, sib, idx, active)
    want5 = [bk.hash_or_noop_mont_planes(x) for x in leaves]
    want6 = bk.permute_planes(states)
    chain9 = torch_bn254_micro.CHAIN
    want9 = {(name, t): mk9.run_probe(name, probes9[name], chain9, t)
             for name, t in K9_AB}
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

    def k9(fn, name, t):
        x = probes9[name]
        out = torch.empty_like(x)
        return out, lambda: fn(x.data_ptr(), out.data_ptr(),
                               mk9.PROBES[name][0], chain9, x.shape[1], t,
                               1, None, stream)

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
        parent9 = (parent_csrc(args.parent) / PARENT["K9"]).read_text()
        if K9_INTERFACE in parent9:
            cases += [(f"K9 {name} threads={t}", "bn254_micro", k9,
                       (name, t), want9[name, t],
                       lambda name=name, t=t: mk9.run_probe(
                           name, probes9[name], chain9, t))
                      for name, t in K9_AB]
        else:
            print("parent: K9 has another interface; not timed", flush=True)
        for label, kernel, make, extra, want, built_call in cases:
            lib, ptxas = built[f"parent_{label.split()[0]}"]
            out, call = make(entry(lib, kernel), *extra)
            times = time_ab(("parent", call), ("built", built_call))
            row = {"kernel": label, **times,
                   "equal": bool(torch.equal(out, want)), "ptxas": ptxas}
            report["parent"].append(row)
            print(f"parent {row}", flush=True)

    def k9_census():
        """Each K9 run's opcodes (its template instance's) beside its
        time."""
        sass = function_census(sass_text(_build.lib_path("bn254_micro",
                                                         texts)))
        rows, _ = torch_bn254_micro.measure(
            device=cs.DEVICE, log=lambda m: print(m, flush=True))
        for r in rows:
            inst = torch_bn254_micro.kernel_instance(r["probe"],
                                                     r["threads"], r["k"])
            ops = sass[inst]
            row = {**r, "instance": inst,
                   "instructions": sum(ops.values()),
                   **{op: ops[op] for op in K9_OPCODES}}
            report["k9"].append(row)
            print(f"K9 census {r['probe']} threads {r['threads']} k "
                  f"{r['k']} ({inst}): {r['ms']:.4f} ms, "
                  f"{row['instructions']} instructions, "
                  f"{ {op: ops[op] for op in K9_OPCODES} }", flush=True)

    time_built()
    if args.parent:
        parent_ab()
    if "k9" in sweeps:
        k9_census()
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
    for tag, params, _, _ in BODY_VARIANTS if "body" in sweeps else ():
        lib, ptxas = built[tag]
        if tag.endswith("k4"):
            out, call = k4(entry(lib, "bn254_path"))
            want, built_call = want4, lambda: bk.verify_paths_mont_planes(
                node, sib, idx, active)
        else:
            out, call = k9(entry(lib, "bn254_micro"), "permute", 0)
            want, built_call = want9["permute", 0], lambda: mk9.run_probe(
                "permute", probes9["permute"], chain9)
        row = {"tag": tag, **params, **time_ab((tag, call),
                                               ("built", built_call)),
               "equal": bool(torch.equal(out, want)), "ptxas": ptxas}
        report["body"].append(row)
        print(f"body {row}", flush=True)
    time_built()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
