"""The optimized Poseidon-BN254 schedule of the PyTorch port: its tables
against the JAX package's `refimpl/poseidon_bn254_opt.py`, the plain
`permute_mont_limbs_opt` against the naive plain permutation and
`refimpl/poseidon_bn254.py`, the generated constants headers against the
tables, and the kernels' body (`csrc/poseidon_bn254.cuh`) built for the host
by a C++ compiler, with the carry flag emulated, against the plain path.

Inputs are made from a seed with numpy, with the carry-stressing values 0,
1, p - 1, p - 2 and values whose low words are all ones among them; every
result is an integer, so the tolerance is exact equality.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from halo2_plonky2_verifier_tpu.refimpl import poseidon_bn254 as ref
from halo2_plonky2_verifier_tpu.refimpl import poseidon_bn254_opt as ref_opt
from halo2_plonky2_verifier_tpu_torch.constants import poseidon_bn254_opt as tpo
from halo2_plonky2_verifier_tpu_torch.constants.poseidon_bn254 import generate
from halo2_plonky2_verifier_tpu_torch.ops import _build
from halo2_plonky2_verifier_tpu_torch.ops import bn254 as fr
from halo2_plonky2_verifier_tpu_torch.ops import bn254_kernels as bk
from halo2_plonky2_verifier_tpu_torch.ops import goldilocks as gl
from halo2_plonky2_verifier_tpu_torch.ops import poseidon_bn254 as tpb

P = fr.P
R = fr.R
EDGE = (0, 1, P - 1, P - 2, (1 << 64) - 1, (1 << 128) - 1, (1 << 192) - 1,
        (P >> 192 << 192) - 1)
# Goldilocks words that stress the leaf packing: 0, 1, p - 1, p - 2 and the
# u64 values >= p a tampered proof can carry
EDGE_GL = (0, 1, gl.P - 1, gl.P - 2, gl.P, gl.P + 1, (1 << 64) - 1, 1 << 63)
HOST_HARNESS = Path(__file__).resolve().parent / "bn254_body_host.cpp"


def _states(seed, n):
    """n seeded canonical states (host ints), the first len(EDGE) of them
    EDGE rotated by the state's index."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 64, size=(n, 4, 4), dtype=np.uint64)
    vals = [[sum(int(w) << (64 * k) for k, w in enumerate(e)) % P
             for e in s] for s in words]
    for j in range(min(n, len(EDGE))):
        vals[j] = [EDGE[(j + e) % len(EDGE)] for e in range(4)]
    return vals


# ----------------------------------------------------------------------------
# (a) the tables
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("index,name", enumerate(
    ["F", "T_vec", "gammas", "E", "P_mat", "sparse", "M"]))
def test_opt_tables_equal_reference(index, name):
    got, want = tpo.opt_tables()[index], ref_opt.opt_tables()[index]
    if name == "sparse":
        want = [(list(r), list(c)) for r, c in want]
        got = [(list(r), list(c)) for r, c in got]
    assert got == want


def test_round_tables_walk_the_reference_schedule():
    """round_tables lays out the reference's tables by full round."""
    f_vecs, t_vec, gammas, e_vecs, p_mat, sparse, m = ref_opt.opt_tables()
    t = tpo.round_tables()
    assert t["pre"][:4] == f_vecs and t["pre"][4:] == [[0] * 4] * 4
    assert t["post"] == [[0] * 4] * 3 + [t_vec] + e_vecs + [[0] * 4]
    assert t["mix"] == [m] * 3 + [p_mat] + [m] * 4
    assert t["gamma"] == gammas
    assert t["row0"] == [list(r) for r, _ in sparse]
    assert t["col0"] == [list(c) for _, c in sparse]


# ----------------------------------------------------------------------------
# (b) the plain optimized permutation
# ----------------------------------------------------------------------------

def test_permute_opt_equals_naive_and_refimpl():
    states = _states(11, 16)
    x = fr.to_limbs(fr.from_ints([[v * R % P for v in s] for s in states]))
    got = tpb.permute_mont_limbs_opt(x)
    assert torch.equal(got, tpb.permute_mont_limbs(x))
    out = fr.to_ints(fr.from_mont(fr.from_limbs(got)))
    assert out == [ref.permute(s) for s in states]


# ----------------------------------------------------------------------------
# (c) the generated headers
# ----------------------------------------------------------------------------

def _parse_header(text):
    """{array name: list of Fr host ints} from `__constant__ uint32_t` arrays
    of eight limbs a value, and {name: int} from `constexpr` scalars."""
    arrays = {}
    for name, size, body in re.findall(
            r"__constant__ uint32_t (\w+)\[(\d+)\] = \{([^}]*)\};", text):
        limbs = [int(w.rstrip("u"), 16) for w in re.findall(r"0x[0-9a-f]+u",
                                                              body)]
        assert len(limbs) == int(size) and len(limbs) % 8 == 0
        arrays[name] = [sum(w << (32 * k) for k, w in enumerate(
            limbs[i:i + 8])) for i in range(0, len(limbs), 8)]
    scalars = {n: int(v.rstrip("u"), 0) for n, v in re.findall(
        r"constexpr \w+ (\w+) = (\w+);", text)}
    return arrays, scalars


def _flat(nested):
    return [v for row in nested for v in
            (_flat(row) if isinstance(row, (list, tuple)) else [row])]


@pytest.mark.parametrize("key", ["pre", "post", "mix", "gamma", "row0",
                                 "col0"])
def test_opt_header_is_the_montgomery_tables(key):
    arrays, _ = _parse_header(_build.bn254_opt_constants_header())
    want = [v * R % P for v in _flat(tpo.round_tables()[key])]
    assert arrays[f"BN_OPT_{key.upper()}"] == want


def test_naive_header_is_the_montgomery_tables():
    arrays, scalars = _parse_header(_build.bn254_constants_header())
    c, m = generate()
    assert arrays["BN_P"] == [P] and arrays["BN_2P"] == [2 * P]
    assert arrays["BN_R2"] == [R * R % P]
    assert arrays["BN_MDS"] == [v * R % P for v in _flat(m)]
    assert arrays["BN_RC"] == [v * R % P for v in c]
    assert (P * scalars["BN_NP0"]) % (1 << 32) == (1 << 32) - 1
    assert scalars["BN_PARTIAL_ROUNDS"] == 56
    assert scalars["BN_HALF_FULL_ROUNDS"] == 4


# ----------------------------------------------------------------------------
# (d) the kernels' body, built for the host
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_body(tmp_path_factory):
    """The host build of csrc/poseidon_bn254.cuh (tests/bn254_body_host.cpp):
    a function running one of its modes on records of Fr values."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernels' body")
    out = tmp_path_factory.mktemp("bn254_body")
    for name, text in _build.header_texts().items():
        if name in _build.GENERATED:
            (out / name).write_text(text)
    exe = out / "bn254_body_host"
    subprocess.run([cxx, "-std=c++20", "-O1", "-I",
                    str(_build.CSRC), "-I", str(out), "-o", str(exe),
                    str(HOST_HARNESS)], check=True, capture_output=True)

    def run(mode, records):
        if mode == "leaf":              # records of Goldilocks words
            text = f"{mode} {len(records)}\n" + "\n".join(
                " ".join(map(str, [len(rec), *rec])) for rec in records)
        else:                           # records of Fr values
            text = f"{mode} {len(records)}\n" + "\n".join(
                " ".join(str((v >> (64 * k)) & ((1 << 64) - 1))
                         for v in rec for k in range(4)) for rec in records)
        lines = subprocess.run([str(exe)], input=text, capture_output=True,
                               text=True, check=True).stdout.splitlines()
        words = [[int(w) for w in line.split()] for line in lines]
        return [[sum(ws[4 * e + k] << (64 * k) for k in range(4))
                 for e in range(len(ws) // 4)] for ws in words]

    return run


@pytest.mark.parametrize("mode", ["permute", "group"])
def test_host_body_permutation_equals_plain(host_body, mode):
    """The one-thread schedule (K4, K5, K9) and the four-lane one (K6, its
    shuffles emulated by four host threads) give the plain permutation's
    canonical Montgomery outputs."""
    states = _states(12, 24)
    mont = [[v * R % P for v in s] for s in states]
    want = fr.to_ints(tpb.permute_mont(fr.from_ints(mont)))
    assert host_body(mode, mont) == want


def test_host_body_field_ops(host_body):
    """mont_mul keeps its lazy bound (r < a b / R + p, a < 4p, any 256-bit
    b), mont_sqr its own (r <= a^2 / R + p, a < 4p; the S-box's squarings),
    to_mont takes any 256-bit value to below 2p, from_mont is
    canonical."""
    rng = np.random.default_rng(13)
    wide = list(EDGE) + [P, P + 1, 2 * P, 4 * P - 1, R - 1]
    rand = [sum(int(w) << (64 * k) for k, w in enumerate(row))
            for row in rng.integers(0, 1 << 64, size=(40, 4),
                                    dtype=np.uint64)]
    pairs = [[a % (4 * P), b] for a, b in zip(rand[:20], rand[20:])]
    pairs += [[a, b] for a in wide if a < 4 * P for b in wide]
    r_inv = pow(R, -1, P)
    for (a, b), (r,) in zip(pairs, host_body("mont_mul", pairs)):
        assert r % P == a * b * r_inv % P and r < a * b // R + P + 1
    squares = [[a % (4 * P)] for a in rand] + [
        [a] for a in wide + [2 * P - 1, 2 * P + 1, 3 * P, R // 5]
        if a < 4 * P]
    for (a,), (r,) in zip(squares, host_body("mont_sqr", squares)):
        assert r % P == a * a * r_inv % P and r <= a * a // R + P
    singles = [[v] for v in wide + rand]
    for (a,), (r,) in zip(singles, host_body("to_mont", singles)):
        assert r % P == a * R % P and r < 2 * P
    for (a,), (r,) in zip(singles, host_body("from_mont", singles)):
        assert r == a * r_inv % P


@pytest.mark.parametrize("w", [1, 2, 3, 4, 9, 10, 13, 32])
def test_host_body_leaf_hash_equals_plain(host_body, w):
    """K5's leaf hash (poseidon_bn254.cuh:leaf_hash, one thread a leaf)
    gives the plain hash_or_noop's canonical Montgomery hash: w <= 3 packs
    without a permutation; the sponge takes whole chunks (w = 9), a partial
    last chunk covering one slot with one word (w = 10), two slots (13) and
    three (32); on seeded words with the edge values, some >= p, on every
    leaf's first words."""
    rng = np.random.default_rng(14 + w)
    words = rng.integers(0, 1 << 64, size=(w, 3), dtype=np.uint64)
    for leaf in range(3):                     # the edge values, rotated
        for j in range(min(w, len(EDGE_GL))):
            words[j, leaf] = EDGE_GL[(j + leaf) % len(EDGE_GL)]
    want = fr.to_ints(bk.hash_or_noop_mont_planes_plain(
        gl.from_u64(words)).T.contiguous())
    got = host_body("leaf", [[int(v) for v in words[:, leaf]]
                             for leaf in range(3)])
    assert [h for (h,) in got] == want
