"""plonky2's fast partial-round schedule of the Poseidon-Goldilocks
permutation in the PyTorch port: its tables against the JAX package's
derivation and plonky2's own values, the plain `permute_planes_opt_plain`
against the naive plain permutation and `refimpl/poseidon.py`, the generated
constants header against the tables, and the kernels' body
(`csrc/poseidon_gl.cuh`) built for the host by a C++ compiler, in its
one-thread form and its lane-split forms (the lanes coroutines on one host
thread, met at a barrier at every shuffle), and K3's leaf sponge on it,
against the plain path.

Inputs are made from a seed with numpy, with the edge values 0, 1, p - 1,
p - 2 and the u64 values >= p that a tampered proof can carry (p, p + 1,
2^64 - 1) among them; every result is an integer, so the tolerance is exact
equality.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from halo2_plonky2_verifier_tpu.constants import poseidon_goldilocks as jpg
from halo2_plonky2_verifier_tpu.refimpl import poseidon as ref
from halo2_plonky2_verifier_tpu_torch.constants import (
    poseidon_goldilocks as tpg, poseidon_goldilocks_opt as tpo)
from halo2_plonky2_verifier_tpu_torch.ops import _build
from halo2_plonky2_verifier_tpu_torch.ops import goldilocks as gl
from halo2_plonky2_verifier_tpu_torch.ops import merkle_kernels as mk
from halo2_plonky2_verifier_tpu_torch.ops import poseidon as pos

P = gl.P
U64 = (1 << 64) - 1
EDGE = (0, 1, P - 1, P - 2, P, P + 1, U64, 1 << 63, (1 << 32) - 1, 1 << 32,
        U64 - (1 << 32), 2)
HOST_HARNESS = Path(__file__).resolve().parent / "gl_body_host.cpp"


def _states(seed, n):
    """n seeded u64 states (host ints), any u64, the first len(EDGE) of
    them EDGE rotated by the state's index."""
    rng = np.random.default_rng(seed)
    vals = [[int(v) for v in row] for row in
            rng.integers(0, 1 << 64, size=(n, 12), dtype=np.uint64)]
    for j in range(min(n, len(EDGE))):
        vals[j] = [EDGE[(j + e) % len(EDGE)] for e in range(12)]
    return vals


def _plain(states):
    """The naive plain permutation's canonical outputs, host ints."""
    planes = gl.from_u64(np.array(states, dtype=np.uint64).T.copy())
    return [[int(v) for v in row]
            for row in gl.to_u64(pos.permute_planes_plain(planes)).T]


# ----------------------------------------------------------------------------
# (a) the tables
# ----------------------------------------------------------------------------

def test_fast_constants_equal_jax_derivation():
    assert (tpo.derive_fast_partial_round_constants()
            == jpg.derive_fast_partial_round_constants())
    assert tpo.mds_matrix() == jpg.mds_matrix()
    assert (tpo.FAST_PARTIAL_FIRST_ROUND_CONSTANT_PREFIX
            == jpg.FAST_PARTIAL_FIRST_ROUND_CONSTANT_PREFIX)
    assert (tpo.FAST_PARTIAL_ROUND_CONSTANTS_PREFIX
            == jpg.FAST_PARTIAL_ROUND_CONSTANTS_PREFIX)


@pytest.mark.parametrize("key,prefix", [
    ("first", jpg.FAST_PARTIAL_FIRST_ROUND_CONSTANT_PREFIX),
    ("partial", jpg.FAST_PARTIAL_ROUND_CONSTANTS_PREFIX),
    ("w_hat", tpo.FAST_PARTIAL_ROUND_W_HATS_PREFIX),
    ("v", tpo.FAST_PARTIAL_ROUND_VS_PREFIX),
    ("init", tpo.FAST_PARTIAL_ROUND_INITIAL_MATRIX_PREFIX),
])
def test_tables_start_with_plonky2s(key, prefix):
    t = tpo.opt_tables()
    got = {"first": t["first"], "partial": t["partial"],
           "w_hat": t["w_hat"][0], "v": t["v"][0],
           "init": [row[0] for row in t["init"]]}[key]   # plonky2: transposed
    assert got[:len(prefix)] == prefix


def test_table_shapes_and_ranges():
    t = tpo.opt_tables()
    assert len(t["first"]) == 12 and len(t["partial"]) == 22
    assert t["partial"][-1] == 0 and t["m00"] == 25
    assert len(t["init"]) == 11 and all(len(r) == 11 for r in t["init"])
    for key in ("w_hat", "v"):
        assert len(t[key]) == 22 and all(len(r) == 11 for r in t[key])
    flat = (t["first"] + t["partial"] + _build._flat(t["init"])
            + _build._flat(t["w_hat"]) + _build._flat(t["v"]))
    assert all(0 <= v < P for v in flat)


# ----------------------------------------------------------------------------
# (b) the plain fast-schedule permutation
# ----------------------------------------------------------------------------

def test_permute_opt_equals_naive_and_refimpl():
    states = _states(21, 256 + len(EDGE))
    planes = gl.from_u64(np.array(states, dtype=np.uint64).T.copy())
    got = pos.permute_planes_opt_plain(planes)
    naive = pos.permute_planes_plain(planes)
    assert got.equal(naive)
    out = [[int(v) for v in row] for row in gl.to_u64(got).T]
    assert out == [ref.permute(s) for s in states]
    assert out[len(EDGE)] == ref.permute(states[len(EDGE)])
    zero = gl.from_u64(np.zeros((12, 1), dtype=np.uint64))
    kat = [int(v) for v in gl.to_u64(pos.permute_planes_opt_plain(zero))[:, 0]]
    assert kat == tpg.KAT_VECTORS[0][1]


# ----------------------------------------------------------------------------
# (c) the generated header
# ----------------------------------------------------------------------------

def _parse_header(text):
    """{array name: list of ints} from `__constant__ uint64_t` arrays, and
    {name: int} from `constexpr` scalars."""
    arrays = {}
    for name, size, body in re.findall(
            r"__constant__ uint64_t (\w+)\[(\d+)\] = \{([^}]*)\};", text):
        vals = [int(w, 16) for w in re.findall(r"0x([0-9a-f]+)ull", body)]
        assert len(vals) == int(size)
        arrays[name] = vals
    scalars = {n: int(v.rstrip("u")) for n, v in re.findall(
        r"constexpr \w+ (\w+) = (\w+);", text)}
    return arrays, scalars


def test_header_is_the_tables():
    arrays, scalars = _parse_header(_build.gl_constants_header())
    t = tpo.opt_tables()
    assert arrays["GL_RC"] == tpg.ALL_ROUND_CONSTANTS
    assert arrays["GL_FIRST"] == t["first"]
    assert arrays["GL_PARTIAL"] == t["partial"]
    init = arrays["GL_INIT"]
    assert init[:12] == [1] + [0] * 11
    assert [init[12 * (1 + r):12 * (2 + r)] for r in range(11)] == [
        [0] + row for row in t["init"]]
    for key in ("w_hat", "v"):
        rows = arrays[f"GL_{key.upper()}"]
        assert [rows[12 * i:12 * (i + 1)] for i in range(22)] == [
            [0] + row for row in t[key]]
    assert [scalars[f"GL_MDS_CIRC_{i}"] for i in range(12)] == \
        tpg.MDS_MATRIX_CIRC
    assert scalars["GL_MDS_DIAG0"] == tpg.MDS_MATRIX_DIAG[0]
    assert scalars["GL_MDS_M00"] == t["m00"]
    assert scalars["GL_N_PARTIAL_ROUNDS"] == 22
    assert scalars["GL_HALF_N_FULL_ROUNDS"] == 4


# ----------------------------------------------------------------------------
# (d) the kernels' body, built for the host
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_body(tmp_path_factory):
    """The host build of csrc/poseidon_gl.cuh (tests/gl_body_host.cpp): a
    function running one of its modes on records of u64 values."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernels' body")
    out = tmp_path_factory.mktemp("gl_body")
    (out / "poseidon_gl_constants.h").write_text(_build.gl_constants_header())
    exe = out / "gl_body_host"
    subprocess.run([cxx, "-std=c++20", "-O1", "-I",
                    str(_build.CSRC), "-I", str(out), "-o", str(exe),
                    str(HOST_HARNESS)], check=True, capture_output=True)

    def run(mode, records):
        if mode == "sponge":            # records of w words, w first
            records = [[len(rec), *rec] for rec in records]
        text = f"{mode} {len(records)}\n" + "\n".join(
            " ".join(str(v) for v in rec) for rec in records)
        lines = subprocess.run([str(exe)], input=text, capture_output=True,
                               text=True, check=True).stdout.splitlines()
        return [[int(w) for w in line.split()] for line in lines]

    return run


@pytest.mark.parametrize("mode", ["permute", "group4", "group16"])
def test_host_body_permutation_equals_plain(host_body, mode):
    """The one-thread form (K1, K3, K7, K8) and the 4- and 16-lane forms
    (K2) give the naive plain permutation's canonical outputs, on any u64
    input."""
    states = _states(22, 64 + len(EDGE))
    assert host_body(mode, states) == _plain(states)


def test_host_body_field_ops(host_body):
    """The body's reduction (every combination of edge words, so every
    borrow and carry case), products, squares, S-box, 12-term dots and MDS,
    on the edge values and seeded u64s, against host integers."""
    rng = np.random.default_rng(23)
    rand = [int(v) for v in rng.integers(0, 1 << 64, size=64,
                                         dtype=np.uint64)]
    vals = list(EDGE) + rand
    pairs = [[hi, lo] for hi in EDGE + ((1 << 32) + 1, P - (1 << 32))
             for lo in EDGE] + [rand[i:i + 2] for i in range(0, 64, 2)]
    assert host_body("reduce", pairs) == [[((hi << 64) + lo) % P]
                                          for hi, lo in pairs]
    triples = [[a, b, c] for a in EDGE for b in EDGE for c in (0, U64)]
    triples += [rand[i:i + 3] for i in range(0, 60, 3)]
    assert host_body("mul", triples) == [[(a * b + c) % P]
                                         for a, b, c in triples]
    singles = [[v] for v in vals]
    assert host_body("sqr", singles) == [[v * v % P] for v in vals]
    assert host_body("sbox", singles) == [[pow(v, 7, P)] for v in vals]
    dots = [[EDGE[(j + k) % len(EDGE)] for k in range(12)]
            + [U64 if j % 2 else P - 1] * 12 for j in range(len(EDGE))]
    dots += [rand[i:i + 24] for i in range(0, 40, 8)]
    assert host_body("dot", dots) == [
        [sum(x * c for x, c in zip(d[:12], d[12:])) % P] for d in dots]
    states = _states(24, 16)
    m = tpo.mds_matrix()
    assert host_body("mds", states) == [
        [sum(m[r][c] * s[c] for c in range(12)) % P for r in range(12)]
        for s in states]


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 13, 16, 17, 24,
                               32, 135])
def test_host_body_leaf_sponge_equals_plain(host_body, w):
    """K3's sponge (poseidon_gl.cuh:leaf_sponge, one thread a leaf) gives
    the plain hash_no_pad_planes' hash: one partial chunk (w < 8), whole
    chunks (8, 16, 24, 32), a last chunk of one word (9, 17) or more (12,
    13), and plonky2's widest PLONK leaf (135, num_wires); on seeded u64
    words with the edge values, some >= p, on every leaf's first words."""
    rng = np.random.default_rng(25 + w)
    words = rng.integers(0, 1 << 64, size=(w, 3), dtype=np.uint64)
    for leaf in range(3):                     # the edge values, rotated
        for j in range(min(w, len(EDGE))):
            words[j, leaf] = EDGE[(j + leaf) % len(EDGE)]
    want = [[int(v) for v in row] for row in gl.to_u64(
        mk.hash_no_pad_planes_plain(gl.from_u64(words))).T]
    assert host_body("sponge", [[int(v) for v in words[:, leaf]]
                                for leaf in range(3)]) == want
