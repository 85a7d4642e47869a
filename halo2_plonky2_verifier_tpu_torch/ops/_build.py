"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface and loaded with `ctypes`.  The build runs at
first use, never at import, from the sources in this checkout only, into
`build/torch_kernels/` at the repository root.  The Poseidon constants
headers (Goldilocks with its fast partial layer, BN254, and the BN254
optimized schedule) are generated there from the port's copies of the
constants.  A library's file name carries a digest of everything it was
built from (its source, the text of every header in csrc/ and of every
generated one, and the flags), so a changed source, header or constant is
rebuilt and an unchanged one is loaded as it is.  A header change rebuilds
every library, which costs one parallel build.

All sources are compiled at once, one `nvcc` process each.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..constants import poseidon_bn254 as pbc
from ..constants import poseidon_bn254_opt as pbo
from ..constants import poseidon_goldilocks as pc
from ..constants import poseidon_goldilocks_opt as pgo

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
# kernel name -> (source, C entry point, argtypes)
KERNELS = {
    "merkle_path": ("merkle_path.cu", "launch_merkle_path",
                    (_P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P)),
    "leaf_sponge": ("leaf_sponge.cu", "launch_leaf_sponge",
                    (_P, _P, ctypes.c_int, ctypes.c_longlong, _P)),
    "transcript": ("transcript.cu", "launch_transcript",
                   (_P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P)),
    "bn254_path": ("bn254_path.cu", "launch_bn254_path",
                   (_P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P)),
    "bn254_leaf": ("bn254_leaf.cu", "launch_bn254_leaf",
                   (_P, _P, ctypes.c_int, ctypes.c_longlong, _P)),
    "bn254_permute": ("bn254_permute.cu", "launch_bn254_permute",
                      (_P, _P, ctypes.c_longlong, _P)),
    "permute": ("permute.cu", "launch_permute",
                (_P, _P, ctypes.c_longlong, _P)),
    "permute_chained": ("permute_chained.cu", "launch_permute_chained",
                        (_P, _P, ctypes.c_longlong, ctypes.c_int, _P)),
    "bn254_micro": ("bn254_micro.cu", "launch_bn254_micro",
                    (_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_int, ctypes.c_int, _P, _P)),
    "gl_mul_chain": ("gl_mul_chain.cu", "launch_gl_mul_chain",
                     (_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P)),
}

_loaded = {}        # kernel name -> ctypes function
build_log = {}      # kernel name -> nvcc/ptxas output of the last build


def _u64_array(name, values, per_line=4):
    """`__constant__ uint64_t name[len(values)]`, hex, `per_line` a line."""
    rows = ",\n    ".join(
        ", ".join(f"0x{v:016x}ull" for v in values[i:i + per_line])
        for i in range(0, len(values), per_line))
    return f"__constant__ uint64_t {name}[{len(values)}] = {{\n    {rows}}};\n"


def gl_opt_rows():
    """The fast partial layer's tables as the kernels index them, twelve
    entries a row: GL_FIRST [element]; GL_PARTIAL [round]; GL_INIT
    [row][column], the entry matrix bordered by row and column 0 of the
    identity; GL_W_HAT and GL_V [round][element], entry 0 zero (element 0
    takes M00 y in row 0 and no column update)."""
    t = pgo.opt_tables()
    w = pc.SPONGE_WIDTH
    init = [[int(c == 0) for c in range(w)]] + [[0] + row for row in t["init"]]
    return {"GL_FIRST": t["first"], "GL_PARTIAL": t["partial"],
            "GL_INIT": _flat(init),
            "GL_W_HAT": _flat([[0] + row for row in t["w_hat"]]),
            "GL_V": _flat([[0] + row for row in t["v"]])}


def gl_constants_header():
    """Text of poseidon_gl_constants.h, from the port's constants: the
    round counts; the MDS circulant, DIAG[0] and M00 as compile-time
    constants (`constexpr` scalars and the `constexpr` function
    gl_mds_circ, so a product by one is a small multiply-add the compiler
    sees); the naive schedule's round constants GL_RC; and the fast partial
    layer's tables (`gl_opt_rows`), in __constant__ memory."""
    w = pc.SPONGE_WIDTH
    assert all(d == 0 for d in pc.MDS_MATRIX_DIAG[1:])
    circ = "".join(f"constexpr uint32_t GL_MDS_CIRC_{i} = {c}u;\n"
                   for i, c in enumerate(pc.MDS_MATRIX_CIRC))
    select = " : ".join(f"i == {i} ? GL_MDS_CIRC_{i}" for i in range(w - 1))
    return (
        "// Generated by ops/_build.py from constants/poseidon_goldilocks.py"
        " and\n// constants/poseidon_goldilocks_opt.py.\n"
        "#pragma once\n#include <cstdint>\n"
        f"constexpr int GL_HALF_N_FULL_ROUNDS = {pc.HALF_N_FULL_ROUNDS};\n"
        f"constexpr int GL_N_PARTIAL_ROUNDS = {pc.N_PARTIAL_ROUNDS};\n"
        + circ +
        f"constexpr uint32_t GL_MDS_DIAG0 = {pc.MDS_MATRIX_DIAG[0]}u;\n"
        f"constexpr uint32_t GL_MDS_M00 = {pgo.opt_tables()['m00']}u;\n"
        "__host__ __device__ constexpr uint32_t gl_mds_circ(int i) {\n"
        f"  return {select} : GL_MDS_CIRC_{w - 1};\n}}\n"
        + _u64_array("GL_RC", pc.ALL_ROUND_CONSTANTS)
        + "".join(_u64_array(name, vals)
                  for name, vals in gl_opt_rows().items()))


def _limb_array(name, values):
    """`__constant__ uint32_t name[8 * len(values)]`: each Fr value as eight
    little-endian u32 limbs, one value a row."""
    rows = ",\n    ".join(
        ", ".join(f"0x{(v >> (32 * k)) & 0xFFFFFFFF:08x}u" for k in range(8))
        for v in values)
    return (f"__constant__ uint32_t {name}[{8 * len(values)}] = {{\n    "
            f"{rows}}};\n")


def _flat(nested):
    return [v for row in nested for v in
            (_flat(row) if isinstance(row, (list, tuple)) else [row])]


def bn254_constants_header():
    """Text of poseidon_bn254_constants.h: the modulus p and 2p, -p^-1 mod
    2^32, R^2 mod p, and the naive schedule's round constants and MDS in
    Montgomery form (R = 2^256), each Fr as eight little-endian u32 limbs,
    from the port's copy of the constants."""
    p = pbc.P_BN254
    r = 1 << 256
    c, m = pbc.generate()
    np0 = (-pow(p, -1, 1 << 32)) % (1 << 32)
    return (
        "// Generated by ops/_build.py from constants/poseidon_bn254.py.\n"
        "#pragma once\n#include <cstdint>\n"
        f"constexpr int BN_HALF_FULL_ROUNDS = {pbc.FULL_ROUNDS // 2};\n"
        f"constexpr int BN_PARTIAL_ROUNDS = {pbc.PARTIAL_ROUNDS};\n"
        f"constexpr uint32_t BN_NP0 = 0x{np0:08x}u;\n"
        + _limb_array("BN_P", [p]) + _limb_array("BN_2P", [2 * p])
        + _limb_array("BN_R2", [r * r % p])
        + _limb_array("BN_MDS", [v * r % p for v in _flat(m)])
        + _limb_array("BN_RC", [v * r % p for v in c]))


def bn254_opt_constants_header():
    """Text of poseidon_bn254_opt_constants.h: the optimized schedule's
    tables (`constants/poseidon_bn254_opt.py:round_tables`) in Montgomery
    form, each Fr as eight little-endian u32 limbs: BN_OPT_PRE and
    BN_OPT_POST [full round][element], BN_OPT_MIX [full round][row][column],
    BN_OPT_GAMMA [partial round], BN_OPT_ROW0 [partial round][column] and
    BN_OPT_COL0 [partial round][row - 1]."""
    r = 1 << 256
    p = pbc.P_BN254
    tables = pbo.round_tables()
    return (
        "// Generated by ops/_build.py from constants/poseidon_bn254_opt.py.\n"
        "#pragma once\n#include <cstdint>\n"
        + "".join(_limb_array(f"BN_OPT_{key.upper()}",
                              [v * r % p for v in _flat(tables[key])])
                  for key in ("pre", "post", "mix", "gamma", "row0", "col0")))


GENERATED = {"poseidon_gl_constants.h": gl_constants_header,
             "poseidon_bn254_constants.h": bn254_constants_header,
             "poseidon_bn254_opt_constants.h": bn254_opt_constants_header}


def header_texts():
    """{header file name: text} of every header a kernel may include: the
    generated constants headers, and every *.cuh and *.h file in csrc/."""
    texts = {name: fn() for name, fn in GENERATED.items()}
    for path in sorted((*CSRC.glob("*.cuh"), *CSRC.glob("*.h"))):
        texts[path.name] = path.read_text()
    return texts


def find_nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def lib_path(name, texts):
    """Where kernel `name`'s library lives: the digest covers its source,
    the text of every header (`texts`, as from `header_texts`, whether the
    source includes it or not) and the nvcc flags."""
    h = hashlib.sha256()
    h.update((CSRC / KERNELS[name][0]).read_bytes())
    for hdr in sorted(texts):
        h.update(hdr.encode() + b"\0" + texts[hdr].encode() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all():
    """Compile every kernel that is not built yet, all nvcc processes at
    once.  Returns {name: seconds} for the kernels compiled by this call;
    raises RuntimeError with the compiler's output if one fails."""
    texts = header_texts()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in GENERATED:
        (BUILD_DIR / name).write_text(texts[name])
    todo = {n: lib_path(n, texts) for n in KERNELS}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    if not todo:
        return {}
    nvcc = find_nvcc()
    t0 = time.monotonic()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-I", str(BUILD_DIR),
               "-o", str(tmp), str(CSRC / KERNELS[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    seconds, failed = {}, []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.monotonic() - t0
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, path)
        (BUILD_DIR / f"{name}.log").write_text(out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def kernel(name):
    """The C entry point of kernel `name`, building it at first use."""
    fn = _loaded.get(name)
    if fn is None:
        path = lib_path(name, header_texts())
        if not path.exists():
            build_all()
        _, symbol, argtypes = KERNELS[name]
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def check(name, status):
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {status}")
