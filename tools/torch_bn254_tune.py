"""Launch shapes and instruction census of the port's BN254 kernels on a CUDA
card: what bounds K4 and K6 at a given register budget.

Two measurements, each on the card's own build (`ops/_build.py` flags):

  census  `cuobjdump -sass` of the K4, K5 and K6 libraries, as counts of
          each SASS opcode (how many instructions the carry chains of
          poseidon_bn254.cuh lower to);
  sweep   K4 built at other (threads a block, minimum blocks an SM) launch
          bounds and K6 at other threads a block, by substituting them into
          a copy of the source under build/bn254_tune/.  Each variant's
          ptxas registers and spills, its time (`chip_smoke.cuda_ms`: the
          median of 5 launches between their own CUDA events) and whether
          its output equals the built kernel's, on chip_smoke's inputs
          (K4: the BN254 n=2^11 slots, 430,080 paths of depth <= 8; K6:
          4096 states).  The built kernels are timed first and last.

Usage: python3 tools/torch_bn254_tune.py   (one CUDA card, nvcc, cuobjdump)
"""

import collections
import ctypes
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
    bn254_kernels as bk, goldilocks as gl)

OUT = os.path.join(REPO, "build", "bn254_tune")
K4_SHAPES = ((128, 4), (256, 2), (64, 8), (128, 3), (128, 5))
K6_THREADS = (64, 128, 256)


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


def variant(source, subs, tag):
    """Build a copy of csrc/`source` with text substitutions; returns
    (ctypes library, ptxas lines on registers and spills)."""
    text = (_build.CSRC / source).read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{source}: {old!r} not found")
        text = text.replace(old, new)
    src = os.path.join(OUT, f"{tag}.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(OUT, f"lib{tag}.so")
    out = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-I", str(_build.BUILD_DIR), "-o", lib, src],
        check=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True).stdout
    ptxas = [l.strip() for l in out.splitlines()
             if "registers" in l or "spill" in l]
    return ctypes.CDLL(lib), ptxas


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_bn254_tune: no CUDA card")
    os.makedirs(OUT, exist_ok=True)
    _build.build_all()
    print(f"device: {cs.torch_sol_bench.card_line()}", flush=True)
    for name in ("bn254_path", "bn254_leaf", "bn254_permute"):
        ops = census(name)
        print(f"census {name}: {sum(ops.values())} instructions; "
              f"{ops.most_common(12)}", flush=True)

    rng = np.random.default_rng(cs.SEED)
    node, sib, idx, active = cs.path_inputs(
        rng, (8, 8, 8, 4, 0), 1024 * 84, lambda n: cs.rand_fr(rng, (n,)),
        lambda d, n: cs.rand_fr(rng, (d, n)))
    states = gl.from_u64(
        cs.rand_fr(rng, (4096, 4)).reshape(4096, 16).T.copy(), cs.DEVICE)
    want4 = bk.verify_paths_mont_planes(node, sib, idx, active)
    want6 = bk.permute_planes(states)
    stream = torch.cuda.current_stream().cuda_stream
    p = ctypes.c_void_p

    def k4(fn):
        out = torch.empty_like(node)
        return out, lambda: fn(node.data_ptr(), sib.data_ptr(),
                               idx.data_ptr(), active.data_ptr(),
                               out.data_ptr(), node.shape[1],
                               sib.shape[0], stream)

    def k6(fn):
        out = torch.empty_like(states)
        return out, lambda: fn(states.data_ptr(), out.data_ptr(),
                               states.shape[1], stream)

    def built():
        ms4 = cs.cuda_ms(
            lambda: bk.verify_paths_mont_planes(node, sib, idx, active), 5)
        ms6 = cs.cuda_ms(lambda: bk.permute_planes(states), 5)
        print(f"built K4 (128, 4): {ms4:.4f} ms; built K6 (128): "
              f"{ms6:.4f} ms", flush=True)

    built()
    for threads, blocks in K4_SHAPES:
        lib, ptxas = variant("bn254_path.cu", [
            ("constexpr int PATH_THREADS = 128;",
             f"constexpr int PATH_THREADS = {threads};"),
            ("__launch_bounds__(PATH_THREADS, 4)",
             f"__launch_bounds__(PATH_THREADS, {blocks})")],
            f"k4_t{threads}_b{blocks}")
        fn = lib.launch_bn254_path
        fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, ctypes.c_int, p]
        out, call = k4(fn)
        ms = cs.cuda_ms(call, 5)
        print(f"K4 ({threads}, {blocks}): {ms:.4f} ms, equal "
              f"{torch.equal(out, want4)}; {ptxas}", flush=True)
    for threads in K6_THREADS:
        lib, ptxas = variant("bn254_permute.cu", [
            ("constexpr int PERMUTE_THREADS = 128;",
             f"constexpr int PERMUTE_THREADS = {threads};")],
            f"k6_t{threads}")
        fn = lib.launch_bn254_permute
        fn.argtypes = [p, p, ctypes.c_longlong, p]
        out, call = k6(fn)
        ms = cs.cuda_ms(call, 5)
        print(f"K6 ({threads}): {ms:.4f} ms, equal "
              f"{torch.equal(out, want6)}; {ptxas}", flush=True)
    built()


if __name__ == "__main__":
    main()
