"""Instruction census, launch shapes and chain floor of the port's Goldilocks
kernels on a CUDA card: what bounds K1, K2, K3, K7 and K8 on their shared
body K0 (`ops/csrc/poseidon_gl.cuh`).

Three measurements, each on the card's own build (`ops/_build.py` flags):

  census  `cuobjdump -sass` of the K1, K2, K3, K7 and K8 libraries, as
          counts of each SASS opcode (what a permutation lowers to), and
          the size of each loop body (a round, where the rounds are loops);
  sweep   variants built from copies of the sources with text
          substitutions, each in its own directory under build/gl_tune/:
          K1 at other (threads a block, minimum blocks an SM) launch bounds
          and at other unrolling of the round loops (full rounds in
          poseidon_gl.cuh, partial rounds in merkle_path.cu), K2 at a
          fixed (lanes a proof, threads a block) whatever the batch, and
          unrolled; K7 at other (states a thread, threads a block, minimum
          blocks an SM) and partial-round unrolling, and spread over groups
          of four lanes (permute_group<4>), at 2^17 and 2^21 states, beside
          the parent commit's K7 built from its sources (--parent).  Each
          variant's ptxas registers and spills, its time
          (`chip_smoke.cuda_ms`: the median of 5 launches between their own
          CUDA events) and whether its output equals the built kernel's, on chip_smoke's inputs (K1: the n=2^11 slots, 430,080
          paths of depth <= 8; K2: the n=2^11 schedule at B=1024, 57 steps,
          the n=2^5 one at B=4096, 47 steps, and the n=2^11 one at B=2048,
          between the two; K7: seeded states, some words >= p).  The built
          kernels are timed first and last (K7: the parent's and the built
          one first, in turn, and again last, in the opposite order);
  floor   the dependent chain alone: K2 at B=1 (one group of lanes, one
          warp on the card) for each group size, and K8 on one state at a
          chain of 64 (the one-thread permutation's latency).

Usage: python3 tools/torch_gl_tune.py [--out FILE] [--sweeps k1,k2,k7,floor]
       [--parent DIR]   (one CUDA card, nvcc, cuobjdump); FILE (default
build/gl_tune/tune.json) gets every number; DIR holds the csrc/ sources of
the commit to compare K7 with (e.g. `git archive <commit>
halo2_plonky2_verifier_tpu_torch/ops/csrc | tar -x -C DIR`, then DIR/
halo2_plonky2_verifier_tpu_torch/ops/csrc).
"""

import argparse
import collections
import ctypes
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from halo2_plonky2_verifier_tpu_torch.ops import _build  # noqa: E402
from halo2_plonky2_verifier_tpu_torch.ops import (  # noqa: E402
    goldilocks as gl, merkle_kernels as mk, poseidon_kernels as pk,
    transcript_kernels as tk)

OUT = os.path.join(REPO, "build", "gl_tune")
GL_KERNELS = ("merkle_path", "transcript", "leaf_sponge", "permute",
              "permute_chained")
# The text each sweep substitutes, as it stands in the built sources.
K1_SHAPE = ("constexpr int PATH_THREADS = 512;",
            "__launch_bounds__(PATH_THREADS, 1)")
K1_PARTIAL = "constexpr int PATH_PARTIAL_UNROLL = 22;"
FULL_LOOP = "#pragma unroll 1\n  for (int r = "   # both forms' full rounds
GROUP_PARTIAL_LOOP = "#pragma unroll 1\n  for (int i = 0; i < NP; ++i) {"
K2_CHOICE = """    if (b * 16 <= lanes)
      launch<16, 128>(chunks, mask, ys, n_steps, b, st);
    else
      launch<4, 64>(chunks, mask, ys, n_steps, b, st);"""
# K7's launch as it stands in permute.cu, and the forms the sweep inserts
# before its entry point: two states a thread side by side, and one state
# over a group of four lanes (K2's permute_group<4>).
K7_SHAPE = ("constexpr int PERMUTE_THREADS = 1024;",
            "__launch_bounds__(PERMUTE_THREADS, 1)")
K7_PARTIAL = "constexpr int PERMUTE_PARTIAL_UNROLL = 1;"
K7_LAUNCH = """  if (n > 0) {
    const long long blocks = (n + PERMUTE_THREADS - 1) / PERMUTE_THREADS;
    permute_kernel<<<(unsigned)blocks, PERMUTE_THREADS, 0,
                     (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, (int64_t)n);
  }"""
K7_ENTRY = 'extern "C" int launch_permute('
K7_TWO_KERNEL = """// Two states a thread, lanes t and t + THREADS of the block's span, side by
// side round by round, so the states' chains interleave.
template <int PU>
__device__ __forceinline__ void permute_two(uint64_t s[2][gl::W]) {
#pragma unroll 1
  for (int r = 0; r < gl::HALF; ++r) {
    gl::full_round(s[0], r);
    gl::full_round(s[1], r);
  }
  gl::partial_entry(s[0]);
  gl::partial_entry(s[1]);
#pragma unroll (PU)
  for (int i = 0; i < gl::NP; ++i) {
    gl::partial_round(s[0], i);
    gl::partial_round(s[1], i);
  }
#pragma unroll 1
  for (int r = gl::HALF + gl::NP; r < gl::ROUNDS; ++r) {
    gl::full_round(s[0], r);
    gl::full_round(s[1], r);
  }
#pragma unroll
  for (int i = 0; i < gl::W; ++i) {
    s[0][i] = gl::canonicalize(s[0][i]);
    s[1][i] = gl::canonicalize(s[1][i]);
  }
}

template <int THREADS, int MIN_BLOCKS, int PU>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    permute_two_kernel(const uint64_t* __restrict__ in,
                       uint64_t* __restrict__ out, int64_t n) {
  const int64_t first = blockIdx.x * (int64_t)(2 * THREADS) + threadIdx.x;
  int64_t lane[2];
  uint64_t s[2][12];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int64_t l = first + k * THREADS;
    lane[k] = l < n ? l : n - 1;      // past N: a copy of lane N - 1
#pragma unroll
    for (int e = 0; e < 12; ++e) s[k][e] = in[e * n + lane[k]];
  }
  permute_two<PU>(s);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (first + k * THREADS < n) {
#pragma unroll
      for (int e = 0; e < 12; ++e) out[e * n + lane[k]] = s[k][e];
    }
  }
}

template <int THREADS, int MIN_BLOCKS, int PU>
static void launch_two(const void* in, void* out, long long n,
                       cudaStream_t stream) {
  const long long blocks = (n + 2 * THREADS - 1) / (2 * THREADS);
  permute_two_kernel<THREADS, MIN_BLOCKS, PU>
      <<<(unsigned)blocks, THREADS, 0, stream>>>(
          (const uint64_t*)in, (uint64_t*)out, (int64_t)n);
}

"""
# K7 over groups of four lanes, three elements a lane
K7_GROUP_KERNEL = """template <int THREADS>
__global__ void __launch_bounds__(THREADS)
    permute_group_kernel(const uint64_t* __restrict__ in,
                         uint64_t* __restrict__ out, int64_t n) {
  __shared__ gl::GroupTables tables;
  gl::copy_group_tables(tables, threadIdx.x, THREADS);
  __syncthreads();
  constexpr int G = 4, E = gl::Group<G>::E;
  const int64_t state = (blockIdx.x * (int64_t)THREADS + threadIdx.x) / G;
  const int l = threadIdx.x % G;
  const int base = (threadIdx.x % 32) & ~(G - 1);
  const int e0 = gl::Group<G>::first_element(l);
  const int64_t lane = state < n ? state : n - 1;
  uint64_t x[E];
#pragma unroll
  for (int j = 0; j < E; ++j) x[j] = in[(e0 + j) * n + lane];
  gl::permute_group<G>(x, l, base, tables);
  if (state < n) {
#pragma unroll
    for (int j = 0; j < E; ++j) out[(e0 + j) * n + lane] = x[j];
  }
}

template <int THREADS>
static void launch_group(const void* in, void* out, long long n,
                         cudaStream_t stream) {
  const long long blocks = (n * 4 + THREADS - 1) / THREADS;
  permute_group_kernel<THREADS><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const uint64_t*)in, (uint64_t*)out, (int64_t)n);
}

"""


def k1_variant(t, b, full=1, partial=22):
    """(tag, params, source, {file: [(old, new)]}) of K1 at launch bounds
    (t threads, b minimum blocks) and `full` / `partial` rounds unrolled."""
    subs = {"merkle_path.cu": [
        (K1_SHAPE[0], f"constexpr int PATH_THREADS = {t};"),
        (K1_SHAPE[1], f"__launch_bounds__(PATH_THREADS, {b})"),
        (K1_PARTIAL, f"constexpr int PATH_PARTIAL_UNROLL = {partial};")]}
    if full != 1:
        subs["poseidon_gl.cuh"] = [
            (FULL_LOOP, f"#pragma unroll {full}\n  for (int r = ")]
    return (f"k1_t{t}_b{b}_full{full}_partial{partial}",
            {"threads": t, "min_blocks": b, "full_unroll": full,
             "partial_unroll": partial}, "merkle_path.cu", subs)


def k2_variant(g, t, full=1, partial=1):
    """(tag, params, source, subs) of K2 at g lanes a proof and t threads a
    block whatever the batch, with `full` / `partial` rounds unrolled."""
    subs = {"transcript.cu": [
        (K2_CHOICE, f"    launch<{g}, {t}>(chunks, mask, ys, n_steps, b, st);")]}
    if (full, partial) != (1, 1):
        subs["poseidon_gl.cuh"] = [
            (FULL_LOOP, f"#pragma unroll {full}\n  for (int r = "),
            (GROUP_PARTIAL_LOOP,
             f"#pragma unroll {partial}\n  for (int i = 0; i < NP; ++i) {{")]
    return (f"k2_g{g}_t{t}_full{full}_partial{partial}",
            {"group": g, "threads": t, "full_unroll": full,
             "partial_unroll": partial}, "transcript.cu", subs)


def k7_variant(t, b, partial=1):
    """(tag, params, source, subs) of K7, one state a thread, at launch
    bounds (t threads, b minimum blocks) and `partial` rounds unrolled."""
    subs = {"permute.cu": [
        (K7_SHAPE[0], f"constexpr int PERMUTE_THREADS = {t};"),
        (K7_SHAPE[1], f"__launch_bounds__(PERMUTE_THREADS, {b})"),
        (K7_PARTIAL, f"constexpr int PERMUTE_PARTIAL_UNROLL = {partial};")]}
    return (f"k7_s1_t{t}_b{b}_partial{partial}",
            {"states": 1, "threads": t, "min_blocks": b,
             "partial_unroll": partial}, "permute.cu", subs)


def k7_two_variant(t, b, partial):
    """(tag, params, source, subs) of K7, two states a thread."""
    subs = {"permute.cu": [
        (K7_LAUNCH, f"  if (n > 0) launch_two<{t}, {b}, {partial}>(in, out, "
                    f"n, (cudaStream_t)stream);"),
        (K7_ENTRY, K7_TWO_KERNEL + K7_ENTRY)]}
    return (f"k7_s2_t{t}_b{b}_partial{partial}",
            {"states": 2, "threads": t, "min_blocks": b,
             "partial_unroll": partial}, "permute.cu", subs)


def k7_group_variant(t):
    """(tag, params, source, subs) of K7 over groups of four lanes, t
    threads a block."""
    subs = {"permute.cu": [
        (K7_LAUNCH, f"  if (n > 0) launch_group<{t}>(in, out, n, "
                    f"(cudaStream_t)stream);"),
        (K7_ENTRY, K7_GROUP_KERNEL + K7_ENTRY)]}
    return (f"k7_group4_t{t}", {"group": 4, "threads": t}, "permute.cu", subs)


# K1 at other launch bounds, then at other unrolling of the round loops; K2
# at other (lanes a proof, threads a block), then unrolled.
K1_VARIANTS = [k1_variant(t, b) for t, b in (
    (512, 1), (256, 2), (128, 1), (128, 8), (128, 10), (256, 4), (512, 2),
    (1024, 1))] + [k1_variant(t, 1, f, p) for t, f, p in (
        (512, 1, 1), (512, 4, 1), (512, 4, 22), (256, 4, 22), (256, 1, 2))]
K2_VARIANTS = [k2_variant(g, t) for g, t in (
    (16, 128), (16, 64), (16, 256), (4, 32), (4, 64))] + [
        k2_variant(g, t, f, p) for g, t in ((16, 128), (4, 64))
        for f, p in ((1, 2), (4, 22))]
# K7: one state a thread at other launch bounds and unrolling (the built
# kernel is 1024 x 1, partial rounds a loop), two states a thread up to 255
# registers, and the four-lane groups.
K7_VARIANTS = [k7_variant(t, b, p) for t, b, p in (
    (128, 1, 1), (512, 1, 1), (512, 1, 22), (512, 1, 2), (768, 1, 1),
    (1024, 1, 2), (256, 2, 1))] + [k7_two_variant(t, b, p) for t, b, p in (
        (256, 1, 22), (256, 1, 1), (128, 1, 22))] + [
            k7_group_variant(t) for t in (128, 256)]
K7_SIZES = (1 << 17, 1 << 21)


def census(name):
    """(Counter of SASS opcodes in kernel `name`'s built library, its loops):
    each loop (a backward branch) as {"kernel", "start", "end",
    "instructions", "top"}: the instructions from the branch target to the
    branch, and the five commonest opcodes among them."""
    lib = _build.lib_path(name, _build.header_texts())
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    ops = collections.Counter()
    code, loops, kernel = [], [], None
    for line in sass.splitlines():
        f = re.match(r"\s*Function : (\S+)", line)
        if f:
            kernel, code = f.group(1), []
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)"
                     r"\s*([^;]*)", line)
        if not m:
            continue
        addr, op = int(m.group(1), 16), m.group(3)
        ops[op] += 1
        code.append((addr, op))
        b = re.match(r"(0x[0-9a-f]+)", m.group(4)) if op == "BRA" else None
        if b and int(b.group(1), 16) < addr:
            body = [o for a, o in code if a >= int(b.group(1), 16)]
            loops.append({"kernel": kernel, "start": b.group(1),
                          "end": hex(addr), "instructions": len(body),
                          "top": collections.Counter(body).most_common(5)})
    return ops, loops


def variant_source(tag, source, subs, base=None, out=OUT):
    """Copy `source` and every *.cuh header from `base` (default csrc/)
    into `out`/`tag`/ (the copies of the bodies are the ones the source's
    #include finds), each with its text substitutions {file: [(old,
    new)]}; returns the copied source's path."""
    base = pathlib.Path(base or _build.CSRC)
    d = os.path.join(out, tag)
    os.makedirs(d, exist_ok=True)
    for name in (source, *sorted(p.name for p in base.glob("*.cuh"))):
        text = (base / name).read_text()
        for old, new in subs.get(name, ()):
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not found")
            text = text.replace(old, new)
        with open(os.path.join(d, name), "w") as f:
            f.write(text)
    return os.path.join(d, source)


def build_variants(variants, out=OUT):
    """Build every variant (tag, params, source, subs[, base directory of
    the sources]) at once, one nvcc each, under `out`; returns {tag:
    (ctypes library, ptxas lines on registers and spills)}."""
    procs = {}
    for tag, _, source, subs, *base in variants:
        lib = os.path.join(out, tag, f"lib{tag}.so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS,
               "-I", str(_build.CSRC), "-I", str(_build.BUILD_DIR), "-o", lib,
               variant_source(tag, source, subs, *base, out=out)]
        procs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      lib)
    built = {}
    for tag, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{out}")
        built[tag] = (ctypes.CDLL(lib), [
            line.strip() for line in out.splitlines()
            if "registers" in line or "spill" in line])
    return built


def parent_csrc(parent):
    """The csrc/ directory under a --parent directory (or the directory
    itself, if it holds the sources)."""
    sub = pathlib.Path(parent) / "halo2_plonky2_verifier_tpu_torch" / "ops" \
        / "csrc"
    return sub if sub.is_dir() else pathlib.Path(parent)


def time_ab(first, second):
    """Time two (label, fn) pairs in turn, first / second / second / first
    (`cs.cuda_ms`, median of 5 each); returns {label: [ms, ms]}."""
    times = {first[0]: [], second[0]: []}
    for label, fn in (first, second, second, first):
        times[label].append(cs.cuda_ms(fn, 5))
    return times


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(OUT, "tune.json"))
    ap.add_argument("--sweeps", default="k1,k2,k7,floor",
                    help="comma-separated subset of k1,k2,k7,floor")
    ap.add_argument("--parent", default=None,
                    help="directory of the sources to compare K7 with")
    args = ap.parse_args()
    sweeps = set(args.sweeps.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("torch_gl_tune: no CUDA card")
    os.makedirs(OUT, exist_ok=True)
    _build.build_all()
    report = {"card": cs.torch_sol_bench.card_line(), "census": {},
              "built": [], "k1": [], "k2": [], "k7": [], "floor": {}}
    print(f"device: {report['card']}", flush=True)
    for name in GL_KERNELS:
        ops, loops = census(name)
        report["census"][name] = {"ops": dict(ops), "loops": loops}
        print(f"census {name}: {sum(ops.values())} instructions; "
              f"{ops.most_common(14)}", flush=True)
        for loop in loops:
            print(f"  loop {loop['kernel'][:40]} {loop['start']}-"
                  f"{loop['end']}: {loop['instructions']} instructions; "
                  f"{loop['top']}", flush=True)
    variants = ((K1_VARIANTS if "k1" in sweeps else [])
                + (K2_VARIANTS if "k2" in sweeps else [])
                + (K7_VARIANTS if "k7" in sweeps else []))
    if "k7" in sweeps and args.parent:
        variants.append(("k7_parent", {"parent": args.parent}, "permute.cu",
                         {}, parent_csrc(args.parent)))
    built = build_variants(variants)
    for tag, (_, ptxas) in built.items():
        print(f"ptxas {tag}: {ptxas}", flush=True)

    rng = np.random.default_rng(cs.SEED)
    node, sib, idx, active = cs.path_inputs(
        rng, (8, 8, 8, 4, 0), 1024 * 84, lambda n: cs.rand_gl(rng, (n, 4)),
        lambda d, n: cs.rand_gl(rng, (d, n, 4)))
    k2_inputs = [cs.transcript_inputs(rng, cs.TRANSCRIPT_N11, 1024),
                 cs.transcript_inputs(rng, cs.TRANSCRIPT_N5, 4096),
                 cs.transcript_inputs(rng, cs.TRANSCRIPT_N11, 2048)]
    want1 = mk.verify_paths_planes(node, sib, idx, active)
    want2 = [tk.run_steps_planes(c, m) for c, m in k2_inputs]
    c1 = k2_inputs[0][0][:, :, :1].contiguous()   # one proof
    want_b1 = tk.run_steps_planes_plain(c1, k2_inputs[0][1])
    k7_inputs = []
    for n in K7_SIZES:
        x = cs.rand_gl(rng, (12, n))
        x[:, ::1021] |= np.uint64(0xFFFFFFFF00000000)
        k7_inputs.append(gl.from_u64(x, cs.DEVICE))
    want7 = [pk.permute_planes(x) for x in k7_inputs]
    stream = torch.cuda.current_stream().cuda_stream

    def k1_call(fn):
        out = torch.empty_like(node)
        return out, lambda: fn(node.data_ptr(), sib.data_ptr(),
                               idx.data_ptr(), active.data_ptr(),
                               out.data_ptr(), node.shape[1], sib.shape[0],
                               stream)

    def k2_call(fn, chunks, mask):
        out = torch.empty_like(chunks)
        return out, lambda: fn(chunks.data_ptr(), mask.data_ptr(),
                               out.data_ptr(), chunks.shape[0],
                               chunks.shape[2], stream)

    def k7_call(fn, x):
        out = torch.empty_like(x)
        return out, lambda: fn(x.data_ptr(), out.data_ptr(), x.shape[1],
                               stream)

    def time_built():
        row = {"K1": cs.cuda_ms(
            lambda: mk.verify_paths_planes(node, sib, idx, active), 5)}
        for (c, m), label in zip(k2_inputs, ("K2 B=1024", "K2 B=4096")):
            row[label] = cs.cuda_ms(lambda: tk.run_steps_planes(c, m), 5)
        report["built"].append(row)
        print(f"built: {row}", flush=True)

    def k7_parent_ab(order):
        """The parent's K7 beside the built one at each size, in turn."""
        lib, _ = built["k7_parent"]
        fn = lib.launch_permute
        fn.argtypes = list(_build.KERNELS["permute"][2])
        for x, want in zip(k7_inputs, want7):
            out, call = k7_call(fn, x)
            pair = [("parent", call), ("built",
                                       lambda x=x: pk.permute_planes(x))]
            times = time_ab(*(pair if order else pair[::-1]))
            row = {"tag": "k7_parent_vs_built", "N": x.shape[1], **times,
                   "equal": bool(torch.equal(out, want))}
            report["k7"].append(row)
            print(f"K7 {row}", flush=True)

    time_built()
    if "k7" in sweeps and args.parent:
        k7_parent_ab(True)
    for tag, params, _, _ in K1_VARIANTS if "k1" in sweeps else ():
        lib, ptxas = built[tag]
        fn = lib.launch_merkle_path
        fn.argtypes = list(_build.KERNELS["merkle_path"][2])
        out, call = k1_call(fn)
        ms = cs.cuda_ms(call, 5)
        row = {"tag": tag, **params, "ms": ms,
               "equal": bool(torch.equal(out, want1)), "ptxas": ptxas}
        report["k1"].append(row)
        print(f"K1 {row}", flush=True)
    for tag, params, _, _ in K2_VARIANTS if "k2" in sweeps else ():
        lib, ptxas = built[tag]
        fn = lib.launch_transcript
        fn.argtypes = list(_build.KERNELS["transcript"][2])
        row = {"tag": tag, **params, "ptxas": ptxas}
        for (c, m), want, b in zip(k2_inputs, want2, (1024, 4096, 2048)):
            out, call = k2_call(fn, c, m)
            row[f"ms_B{b}"] = cs.cuda_ms(call, 5)
            row[f"equal_B{b}"] = bool(torch.equal(out, want))
        # the chain floor: one proof, one group of lanes
        out, call = k2_call(fn, c1, k2_inputs[0][1])
        row["ms_B1"] = cs.cuda_ms(call, 5)
        row["equal_B1"] = bool(torch.equal(out, want_b1))
        report["k2"].append(row)
        print(f"K2 {row}", flush=True)
    for tag, params, _, _ in K7_VARIANTS if "k7" in sweeps else ():
        lib, ptxas = built[tag]
        fn = lib.launch_permute
        fn.argtypes = list(_build.KERNELS["permute"][2])
        row = {"tag": tag, **params, "ptxas": ptxas}
        for x, want in zip(k7_inputs, want7):
            out, call = k7_call(fn, x)
            row[f"ms_N{x.shape[1]}"] = cs.cuda_ms(call, 5)
            row[f"equal_N{x.shape[1]}"] = bool(torch.equal(out, want))
        report["k7"].append(row)
        print(f"K7 {row}", flush=True)
    if "floor" in sweeps:
        one = gl.from_u64(cs.rand_gl(rng, (12, 1)), cs.DEVICE)
        ms8 = cs.cuda_ms(lambda: pk.permute_planes_chained(one, 64), 5)
        report["floor"] = {"K8 N=1 chain=64 ms": ms8,
                           "one-thread permutation us": ms8 / 64 * 1e3}
        print(f"floor: {report['floor']}", flush=True)
    if "k7" in sweeps and args.parent:
        k7_parent_ab(False)
    time_built()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
