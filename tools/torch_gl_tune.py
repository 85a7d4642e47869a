"""Instruction census, launch shapes and chain floor of the port's Goldilocks
kernels on a CUDA card: what bounds K1, K2, K3, K7 and K8 on their shared
body K0 (`ops/csrc/poseidon_gl.cuh`).

Three measurements, each on the card's own build (`ops/_build.py` flags):

  census  `cuobjdump -sass` of the K1, K2, K3, K7 and K8 libraries, as
          counts of each SASS opcode (what a permutation lowers to), and
          the size of each loop body (a round, where the rounds are loops);
          with --parent, whether each one's SASS equals the parent's;
  sweep   variants built from copies of the sources with text
          substitutions, each in its own directory under build/gl_tune/:
          K1 at other (threads a block, minimum blocks an SM) launch bounds
          and at other unrolling of the round loops (full rounds in
          poseidon_gl.cuh, partial rounds in merkle_path.cu), K2 at a
          fixed (lanes a proof, threads a block) whatever the batch, and
          unrolled; K7 at other (states a thread, threads a block, minimum
          blocks an SM) and partial-round unrolling, and spread over groups
          of four lanes (permute_group<4>), at 2^17 and 2^21 states; K3
          (w=32 at 172,032 and 688,128 leaves) and K8 (chain 64 at 2^18
          states, chain 4 at 2^20) at other launch bounds and unrolling of
          their launch sized to the card, on one round of blocks, and at
          fixed launches, K3 also with a last permutation that computes
          only the four words it hashes.  Each variant's ptxas registers
          and spills, its time (`chip_smoke.cuda_ms`: the median of 5
          launches between their own CUDA events) and whether its output
          equals the built kernel's, on chip_smoke's inputs (K1: the n=2^11
          slots, 430,080 paths of depth <= 8; K2: the n=2^11 schedule at
          B=1024, 57 steps, the n=2^5 one at B=4096, 47 steps, and the
          n=2^11 one at B=2048, between the two; K3, K7, K8: seeded words,
          some >= p).  The built kernels are timed first and last; with
          --parent, the parent commit's K3, K7 and K8, built from its
          sources, and the built ones are timed first, in turn (parent,
          built, built, parent), and again last in the opposite order;
  floor   the dependent chain alone: K2 at B=1 (one group of lanes, one
          warp on the card) for each group size, and K8 on one state at a
          chain of 64 (the one-thread permutation's latency).

Usage: python3 tools/torch_gl_tune.py [--out FILE]
       [--sweeps k1,k2,k3,k7,k8,floor] [--parent DIR]   (one CUDA card,
nvcc, cuobjdump); FILE (default build/gl_tune/tune.json) gets every number;
DIR holds the csrc/ sources of the commit to compare with (e.g. `git
archive <commit> halo2_plonky2_verifier_tpu_torch/ops/csrc | tar -x -C DIR`,
then DIR/halo2_plonky2_verifier_tpu_torch/ops/csrc).
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

# K3's and K8's launch as they stand in leaf_sponge.cu and permute_chained.cu
# (sized to the card by sized_launch.cuh, at most THREADS a block; K3 with a
# lane loop that runs once as launched, K8 one lane a thread), and the forms
# the sweeps put in its place: the sized threads rounded up to one warp in
# place of four (one a scheduler) ("sized32"); the sized launch one lane a
# thread ("single") and with each thread taking every grid-th lane
# ("loop"), the latter on at most one round of blocks ("persistent"); THREADS
# a block on at most one round of blocks, each thread taking every grid-th
# lane ("resident", one thread a slot); a fixed launch of ceil(n / THREADS)
# blocks ("fixed").
K3_SHAPE = ("constexpr int SPONGE_THREADS = 1024;",
            "constexpr int SPONGE_MIN_BLOCKS = 1;")
K3_PARTIAL = "constexpr int SPONGE_PARTIAL_UNROLL = 1;"
K3_SIZED = """    const cudaError_t e = sized_launch<SPONGE_THREADS>(
        card, leaf_sponge_kernel, n, threads, blocks);"""
K3_TAIL = "out[k * n + lane] = h[k];\n  }\n}"
K8_SHAPE = ("constexpr int CHAINED_THREADS = 1024;",
            "constexpr int CHAINED_MIN_BLOCKS = 1;")
K8_PARTIAL = "constexpr int CHAINED_PARTIAL_UNROLL = 1;"
K8_SIZED = """    const cudaError_t e = sized_launch<CHAINED_THREADS>(
        card, permute_chained_kernel, n, threads, blocks);"""
K8_TAIL = "out[e * n + lane] = s[e];\n}"
LANE = """  const int64_t lane = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (lane >= n) return;"""
LANE_LOOP = """  for (int64_t lane = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       lane < n; lane += (int64_t)gridDim.x * blockDim.x) {"""
SIZED_THREADS = "threads = (int)((lanes + 127) / 128 * 128);"
SIZED_BLOCKS = "blocks = (n + threads - 1) / threads;"
ONE_ROUND = "\n  if (blocks > slots) blocks = slots;"
# K3 whose last permutation computes only the rows it hashes: the last
# round's mix gives state[0:4] (inserted before leaf_sponge, which calls it
# for its last chunk).
K3_LAST_PERMUTE = "    poseidon_gl_permute<PARTIAL_UNROLL>(s);\n  }"
K3_SPONGE = ("template <int PARTIAL_UNROLL = 1>\n__device__ __forceinline__ "
             "void leaf_sponge(")
K3_HEAD4 = """// The permutation of which only state[0:4] is read: the last
// round's mix computes rows 0..3 alone.
template <int PARTIAL_UNROLL = 1>
__device__ __forceinline__ void permute_head4(uint64_t s[W]) {
#pragma unroll 1
  for (int r = 0; r < HALF; ++r) full_round(s, r);
  partial_entry(s);
#pragma unroll (PARTIAL_UNROLL)
  for (int i = 0; i < NP; ++i) partial_round(s, i);
#pragma unroll 1
  for (int r = HALF + NP; r < ROUNDS - 1; ++r) full_round(s, r);
#pragma unroll
  for (int i = 0; i < W; ++i)
    s[i] = sbox(add_lazy(s[i], GL_RC[(ROUNDS - 1) * W + i]));
  uint64_t out[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint64_t sum_lo = 0, sum_hi = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint64_t x = s[(r + i) % W];
      sum_lo += (uint64_t)(uint32_t)x * gl_mds_circ(i);
      sum_hi += (x >> 32) * gl_mds_circ(i);
    }
    if (r == 0) {
      sum_lo += (uint64_t)(uint32_t)s[0] * GL_MDS_DIAG0;
      sum_hi += (s[0] >> 32) * GL_MDS_DIAG0;
    }
    out[r] = reduce_halves(sum_lo, sum_hi);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) s[r] = canonicalize(out[r]);
}

"""


def chain_variant(k, t, b, partial=1, launch="sized", head4=False):
    """(tag, params, source, subs) of K3 (k = "k3") or K8 ("k8") at launch
    bounds (t threads, b minimum blocks), `partial` rounds unrolled, and
    `launch` "sized" (the built form), "sized32", "single", "loop",
    "persistent", "resident" or "fixed"; K3 with `head4`, its last
    permutation computing state[0:4] alone."""
    source, shape, part, sized, tail, prefix, looped = {
        "k3": ("leaf_sponge.cu", K3_SHAPE, K3_PARTIAL, K3_SIZED, K3_TAIL,
               "SPONGE", True),
        "k8": ("permute_chained.cu", K8_SHAPE, K8_PARTIAL, K8_SIZED, K8_TAIL,
               "CHAINED", False)}[k]
    subs = {source: [
        (shape[0], f"constexpr int {prefix}_THREADS = {t};"),
        (shape[1], f"constexpr int {prefix}_MIN_BLOCKS = {b};"),
        (part, f"constexpr int {prefix}_PARTIAL_UNROLL = {partial};")]}
    loop = {"single": False, "loop": True, "persistent": True,
            "resident": True}.get(launch, looped)
    if loop != looped:       # the lane loop put in or taken out
        if loop:
            subs[source] += [(LANE, LANE_LOOP),
                             (tail, tail.replace("\n}", "\n  }\n}"))]
        else:
            subs[source] += [(LANE_LOOP, LANE),
                             (tail, tail.replace("\n  }\n}", "\n}"))]
    sizing = []
    if launch == "fixed":
        subs[source].append((sized, f"""    threads = {prefix}_THREADS;
    blocks = (n + threads - 1) / threads;
    const cudaError_t e = cudaSuccess;"""))
    elif launch == "sized32":
        sizing.append((SIZED_THREADS,
                       "threads = (int)((lanes + 31) / 32 * 32);"))
    elif launch in ("persistent", "resident"):
        sizing.append((SIZED_BLOCKS, SIZED_BLOCKS + ONE_ROUND))
        if launch == "resident":
            sizing.append((SIZED_THREADS, "threads = MAX_THREADS;"))
    if sizing:
        subs["sized_launch.cuh"] = sizing
    if head4:
        subs["poseidon_gl.cuh"] = [
            (K3_LAST_PERMUTE, "    if (off + 8 < w)\n  "
             + K3_LAST_PERMUTE.split("\n")[0] + "\n    else\n"
             "      permute_head4<PARTIAL_UNROLL>(s);\n  }"),
            (K3_SPONGE, K3_HEAD4 + K3_SPONGE)]
    return (f"{k}_{launch}_t{t}_b{b}_partial{partial}"
            + ("_head4" if head4 else ""),
            {"threads": t, "min_blocks": b, "partial_unroll": partial,
             "launch": launch, "head4": head4}, source, subs)


# K3 and K8: the sized launch at other launch bounds and unrolling (the
# built kernels: sized, 1024 x 1, partial rounds a loop), in blocks of
# whole warps, with and without a lane loop, on one round of blocks, and
# fixed launches (1024 x 1 is K7's; 512 x 2 has K1's block size at K7's 64
# registers); K3 also with the short last permutation.
CHAIN_SHAPES = [(1024, 1, 1, "sized"), (768, 1, 1, "sized"),
                (512, 1, 1, "sized"), (1024, 1, 2, "sized"),
                (512, 2, 1, "sized"), (1024, 1, 1, "sized32"),
                (1024, 1, 1, "single"), (1024, 1, 1, "loop"),
                (1024, 1, 1, "persistent"), (1024, 1, 1, "resident"),
                (1024, 1, 1, "fixed"), (512, 2, 1, "fixed"),
                (512, 1, 1, "fixed"), (128, 4, 1, "fixed")]
K3_VARIANTS = [chain_variant("k3", *v) for v in CHAIN_SHAPES] + [
    chain_variant("k3", 1024, 1, head4=True)]
K8_VARIANTS = [chain_variant("k8", *v) for v in CHAIN_SHAPES]
# K3 at the GL n=2^11 drive's step leaves (B=1024) and at B=4096; K8 at the
# SOL bench's chained and mid probes: (w or chain, N)
K3_SIZES = ((32, 172_032), (32, 688_128))
K8_SIZES = ((64, 1 << 18), (4, 1 << 20))


def census(lib):
    """(Counter of SASS opcodes in the library `lib`, its loops, its
    instructions): each loop (a backward branch) as {"kernel", "start",
    "end", "instructions", "top"}: the instructions from the branch target
    to the branch, and the five commonest opcodes among them; the
    instructions as text (predicate, opcode and operands), in order."""
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    ops = collections.Counter()
    code, loops, kernel, text = [], [], None, []
    for line in sass.splitlines():
        f = re.match(r"\s*Function : (\S+)", line)
        if f:
            kernel, code = f.group(1), []
            text.append(line.strip())
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)"
                     r"\s*([^;]*)", line)
        if not m:
            continue
        addr, op = int(m.group(1), 16), m.group(3)
        ops[op] += 1
        code.append((addr, op))
        text.append(f"{m.group(2) or ''}{op} {m.group(4)}".strip())
        b = re.match(r"(0x[0-9a-f]+)", m.group(4)) if op == "BRA" else None
        if b and int(b.group(1), 16) < addr:
            body = [o for a, o in code if a >= int(b.group(1), 16)]
            loops.append({"kernel": kernel, "start": b.group(1),
                          "end": hex(addr), "instructions": len(body),
                          "top": collections.Counter(body).most_common(5)})
    return ops, loops, text


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
    ap.add_argument("--sweeps", default="k1,k2,k3,k7,k8,floor",
                    help="comma-separated subset of k1,k2,k3,k7,k8,floor")
    ap.add_argument("--parent", default=None,
                    help="directory of the sources to compare with")
    args = ap.parse_args()
    sweeps = set(args.sweeps.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("torch_gl_tune: no CUDA card")
    os.makedirs(OUT, exist_ok=True)
    _build.build_all()
    report = {"card": cs.torch_sol_bench.card_line(), "census": {},
              "built": [], "k1": [], "k2": [], "k3": [], "k7": [], "k8": [],
              "floor": {}}
    print(f"device: {report['card']}", flush=True)
    texts = _build.header_texts()
    sass = {}
    for name in GL_KERNELS:
        ops, loops, sass[name] = census(_build.lib_path(name, texts))
        report["census"][name] = {"ops": dict(ops), "loops": loops}
        print(f"census {name}: {sum(ops.values())} instructions; "
              f"{ops.most_common(14)}", flush=True)
        for loop in loops:
            print(f"  loop {loop['kernel'][:40]} {loop['start']}-"
                  f"{loop['end']}: {loop['instructions']} instructions; "
                  f"{loop['top']}", flush=True)
    variants = ((K1_VARIANTS if "k1" in sweeps else [])
                + (K2_VARIANTS if "k2" in sweeps else [])
                + (K3_VARIANTS if "k3" in sweeps else [])
                + (K7_VARIANTS if "k7" in sweeps else [])
                + (K8_VARIANTS if "k8" in sweeps else []))
    if args.parent:       # the parent's build of every GL kernel
        variants += [(f"parent_{name}", {"parent": args.parent},
                      _build.KERNELS[name][0], {}, parent_csrc(args.parent))
                     for name in GL_KERNELS]
    built = build_variants(variants)
    for tag, (_, ptxas) in built.items():
        print(f"ptxas {tag}: {ptxas}", flush=True)
    if args.parent:
        for name in GL_KERNELS:
            lib = os.path.join(OUT, f"parent_{name}", f"libparent_{name}.so")
            same = census(lib)[2] == sass[name]
            report["census"][name]["sass_equal_parent"] = same
            print(f"census {name}: SASS equal to the parent's: {same}",
                  flush=True)

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
    # K3: (w, leaves) planes, some words >= p; K8: (12, N) states
    k3_inputs = []
    for w, n in K3_SIZES if "k3" in sweeps else ():
        x = cs.rand_gl(rng, (w, n))
        x[:, ::1021] |= np.uint64(0xFFFFFFFF00000000)
        k3_inputs.append(gl.from_u64(x, cs.DEVICE))
    want3 = [mk.hash_no_pad_planes(x) for x in k3_inputs]
    k8_inputs = [(gl.from_u64(cs.rand_gl(rng, (12, n)), cs.DEVICE), chain)
                 for chain, n in (K8_SIZES if "k8" in sweeps else ())]
    want8 = [pk.permute_planes_chained(x, c) for x, c in k8_inputs]
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

    def k3_call(fn, x):
        out = torch.empty((4, x.shape[1]), dtype=x.dtype, device=x.device)
        return out, lambda: fn(x.data_ptr(), out.data_ptr(), x.shape[0],
                               x.shape[1], stream)

    def k8_call(fn, x, chain):
        out = torch.empty_like(x)
        return out, lambda: fn(x.data_ptr(), out.data_ptr(), x.shape[1],
                               chain, stream)

    # per sweep: (kernel name, [(label, the wrapper's arguments, the built
    # kernel's output)], call maker, the wrapper)
    chains = {
        "k3": ("leaf_sponge",
               [(f"w{x.shape[0]}_N{x.shape[1]}", (x,), y)
                for x, y in zip(k3_inputs, want3)],
               k3_call, mk.hash_no_pad_planes),
        "k7": ("permute",
               [(f"N{x.shape[1]}", (x,), y) for x, y in zip(k7_inputs, want7)],
               k7_call, pk.permute_planes),
        "k8": ("permute_chained",
               [(f"chain{c}_N{x.shape[1]}", (x, c), y)
                for (x, c), y in zip(k8_inputs, want8)],
               k8_call, pk.permute_planes_chained)}

    def lib_fn(lib, name):
        fn = getattr(lib, _build.KERNELS[name][1])
        fn.argtypes = list(_build.KERNELS[name][2])
        return fn

    def time_built():
        row = {"K1": cs.cuda_ms(
            lambda: mk.verify_paths_planes(node, sib, idx, active), 5)}
        for (c, m), label in zip(k2_inputs, ("K2 B=1024", "K2 B=4096")):
            row[label] = cs.cuda_ms(lambda: tk.run_steps_planes(c, m), 5)
        report["built"].append(row)
        print(f"built: {row}", flush=True)

    def parent_ab(order):
        """The parent's K3, K7 and K8 beside the built ones at each size, in
        turn: parent, built, built, parent (or the reverse)."""
        for sweep, (name, cases, call, wrapper) in chains.items():
            if sweep not in sweeps:
                continue
            fn = lib_fn(built[f"parent_{name}"][0], name)
            for label, args_, want in cases:
                out, run = call(fn, *args_)
                pair = [("parent", run), ("built", lambda: wrapper(*args_))]
                times = time_ab(*(pair if order else pair[::-1]))
                row = {"tag": f"{sweep}_parent_vs_built", "size": label,
                       **times, "equal": bool(torch.equal(out, want))}
                report[sweep].append(row)
                print(f"{sweep.upper()} {row}", flush=True)

    time_built()
    if args.parent:
        parent_ab(True)
    for tag, params, _, _ in K1_VARIANTS if "k1" in sweeps else ():
        lib, ptxas = built[tag]
        out, call = k1_call(lib_fn(lib, "merkle_path"))
        ms = cs.cuda_ms(call, 5)
        row = {"tag": tag, **params, "ms": ms,
               "equal": bool(torch.equal(out, want1)), "ptxas": ptxas}
        report["k1"].append(row)
        print(f"K1 {row}", flush=True)
    for tag, params, _, _ in K2_VARIANTS if "k2" in sweeps else ():
        lib, ptxas = built[tag]
        fn = lib_fn(lib, "transcript")
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
    for sweep, table in (("k3", K3_VARIANTS), ("k7", K7_VARIANTS),
                         ("k8", K8_VARIANTS)):
        if sweep not in sweeps:
            continue
        name, cases, call, _ = chains[sweep]
        for tag, params, _, _ in table:
            lib, ptxas = built[tag]
            fn = lib_fn(lib, name)
            row = {"tag": tag, **params, "ptxas": ptxas}
            for label, args_, want in cases:
                out, run = call(fn, *args_)
                row[f"ms_{label}"] = cs.cuda_ms(run, 5)
                row[f"equal_{label}"] = bool(torch.equal(out, want))
            report[sweep].append(row)
            print(f"{sweep.upper()} {row}", flush=True)
    if "floor" in sweeps:
        one = gl.from_u64(cs.rand_gl(rng, (12, 1)), cs.DEVICE)
        ms8 = cs.cuda_ms(lambda: pk.permute_planes_chained(one, 64), 5)
        report["floor"] = {"K8 N=1 chain=64 ms": ms8,
                           "one-thread permutation us": ms8 / 64 * 1e3}
        print(f"floor: {report['floor']}", flush=True)
    if args.parent:
        parent_ab(False)
    time_built()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
