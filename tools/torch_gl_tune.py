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
          unrolled.  Each variant's ptxas registers and spills, its time
          (`chip_smoke.cuda_ms`: the median of 5 launches between their own
          CUDA events) and whether its output equals the built kernel's, on chip_smoke's inputs (K1: the n=2^11 slots, 430,080
          paths of depth <= 8; K2: the n=2^11 schedule at B=1024, 57 steps,
          the n=2^5 one at B=4096, 47 steps, and the n=2^11 one at B=2048,
          between the two).  The built kernels are timed first and last;
  floor   the dependent chain alone: K2 at B=1 (one group of lanes, one
          warp on the card) for each group size, and K8 on one state at a
          chain of 64 (the one-thread permutation's latency).

Usage: python3 tools/torch_gl_tune.py [--out FILE]   (one CUDA card, nvcc,
cuobjdump); FILE (default build/gl_tune/tune.json) gets every number.
"""

import argparse
import collections
import ctypes
import json
import os
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


def variant_source(tag, source, subs):
    """Copy csrc/`source` and poseidon_gl.cuh into OUT/`tag`/ (the copy of
    the body is the one the source's #include finds), each with its text
    substitutions {file: [(old, new)]}; returns the copied source's path."""
    d = os.path.join(OUT, tag)
    os.makedirs(d, exist_ok=True)
    for name in (source, "poseidon_gl.cuh"):
        text = (_build.CSRC / name).read_text()
        for old, new in subs.get(name, ()):
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not found")
            text = text.replace(old, new)
        with open(os.path.join(d, name), "w") as f:
            f.write(text)
    return os.path.join(d, source)


def build_variants(variants):
    """Build every variant at once, one nvcc each; returns {tag: (ctypes
    library, ptxas lines on registers and spills)}."""
    procs = {}
    for tag, _, source, subs in variants:
        lib = os.path.join(OUT, tag, f"lib{tag}.so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS,
               "-I", str(_build.CSRC), "-I", str(_build.BUILD_DIR), "-o", lib,
               variant_source(tag, source, subs)]
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(OUT, "tune.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_gl_tune: no CUDA card")
    os.makedirs(OUT, exist_ok=True)
    _build.build_all()
    report = {"card": cs.torch_sol_bench.card_line(), "census": {},
              "built": [], "k1": [], "k2": [], "floor": {}}
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
    built = build_variants(K1_VARIANTS + K2_VARIANTS)

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

    def time_built():
        row = {"K1": cs.cuda_ms(
            lambda: mk.verify_paths_planes(node, sib, idx, active), 5)}
        for (c, m), label in zip(k2_inputs, ("K2 B=1024", "K2 B=4096")):
            row[label] = cs.cuda_ms(lambda: tk.run_steps_planes(c, m), 5)
        report["built"].append(row)
        print(f"built: {row}", flush=True)

    time_built()
    for tag, params, _, _ in K1_VARIANTS:
        lib, ptxas = built[tag]
        fn = lib.launch_merkle_path
        fn.argtypes = list(_build.KERNELS["merkle_path"][2])
        out, call = k1_call(fn)
        ms = cs.cuda_ms(call, 5)
        row = {"tag": tag, **params, "ms": ms,
               "equal": bool(torch.equal(out, want1)), "ptxas": ptxas}
        report["k1"].append(row)
        print(f"K1 {row}", flush=True)
    for tag, params, _, _ in K2_VARIANTS:
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
    one = gl.from_u64(cs.rand_gl(rng, (12, 1)), cs.DEVICE)
    ms8 = cs.cuda_ms(lambda: pk.permute_planes_chained(one, 64), 5)
    report["floor"] = {"K8 N=1 chain=64 ms": ms8,
                       "one-thread permutation us": ms8 / 64 * 1e3}
    print(f"floor: {report['floor']}", flush=True)
    time_built()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
