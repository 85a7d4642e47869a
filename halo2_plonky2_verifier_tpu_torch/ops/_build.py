"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface and loaded with `ctypes`.  The build runs at
first use, never at import, from the sources in this checkout only, into
`build/torch_kernels/` at the repository root.  The Poseidon constants header
is generated there from the port's copy of the constants.  A library's file
name carries a digest of everything it was built from, so a changed source
is rebuilt and an unchanged one is loaded as it is.

All sources are compiled at once, one `nvcc` process each.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..constants import poseidon_goldilocks as pc

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
}
_HEADERS = ("poseidon_gl.cuh",)

_loaded = {}        # kernel name -> ctypes function
build_log = {}      # kernel name -> nvcc/ptxas output of the last build


def constants_header():
    """Text of poseidon_gl_constants.h, from the port's constants."""
    rc = ",\n    ".join(
        ", ".join(f"0x{c:016x}ull" for c in pc.ALL_ROUND_CONSTANTS[i:i + 4])
        for i in range(0, len(pc.ALL_ROUND_CONSTANTS), 4))
    circ = ", ".join(f"{c}ull" for c in pc.MDS_MATRIX_CIRC)
    assert all(d == 0 for d in pc.MDS_MATRIX_DIAG[1:])
    return (
        "// Generated by ops/_build.py from constants/poseidon_goldilocks.py.\n"
        "#pragma once\n#include <cstdint>\n"
        f"constexpr int GL_HALF_N_FULL_ROUNDS = {pc.HALF_N_FULL_ROUNDS};\n"
        f"constexpr int GL_N_PARTIAL_ROUNDS = {pc.N_PARTIAL_ROUNDS};\n"
        f"constexpr uint64_t GL_MDS_DIAG0 = {pc.MDS_MATRIX_DIAG[0]}ull;\n"
        f"__constant__ uint64_t GL_MDS_CIRC[{pc.SPONGE_WIDTH}] = {{{circ}}};\n"
        f"__constant__ uint64_t GL_RC[{len(pc.ALL_ROUND_CONSTANTS)}] = {{\n"
        f"    {rc}}};\n")


def find_nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name, header):
    h = hashlib.sha256()
    for part in (KERNELS[name][0],) + _HEADERS:
        h.update((CSRC / part).read_bytes())
    h.update(header.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all():
    """Compile every kernel that is not built yet, all nvcc processes at
    once.  Returns {name: seconds} for the kernels compiled by this call;
    raises RuntimeError with the compiler's output if one fails."""
    header = constants_header()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    (BUILD_DIR / "poseidon_gl_constants.h").write_text(header)
    todo = {n: _lib_path(n, header) for n in KERNELS}
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
        header = constants_header()
        path = _lib_path(name, header)
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
