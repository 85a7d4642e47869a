"""The PyTorch port's BN254 field, permutation and kernel plain versions
against the JAX package: the Fr functions against `ops/bn254.py` (one
smart_jit compile for all of them), and the permutation, `two_to_one`,
`hash_or_noop` and the plain versions of kernels K4, K5 and K6 against the
pure-int reference `refimpl/poseidon_bn254.py` (a JIT of the JAX
permutation would take minutes to compile on the CPU).

Inputs are made from a seed with numpy / random; integer results, so the
tolerance is 0.
"""

import random
import re

import numpy as np
import pytest
import torch

from halo2_plonky2_verifier_tpu.constants import poseidon_bn254 as jconst
from halo2_plonky2_verifier_tpu.ops import bn254 as jfr
from halo2_plonky2_verifier_tpu.refimpl import poseidon_bn254 as ref
from halo2_plonky2_verifier_tpu.utils.compile import smart_jit
from halo2_plonky2_verifier_tpu_torch.constants import poseidon_bn254 as tconst
from halo2_plonky2_verifier_tpu_torch.ops import _build
from halo2_plonky2_verifier_tpu_torch.ops import bn254 as fr
from halo2_plonky2_verifier_tpu_torch.ops import bn254_kernels as bk
from halo2_plonky2_verifier_tpu_torch.ops import poseidon_bn254 as tpb

P = fr.P
R = fr.R
R_INV = pow(R, -1, P)
GL_P = (1 << 64) - (1 << 32) + 1


def _ints(seed, n, bound=P, edge=(0, 1, P - 1)):
    rng = random.Random(seed)
    vals = [rng.randrange(bound) for _ in range(n)]
    vals[:len(edge)] = edge
    return vals


def _limbs16(vals):
    """Host ints -> (n, 16) uint32 limbs (the JAX package's Fr form)."""
    return np.array([[(v >> (16 * k)) & 0xFFFF for k in range(16)]
                     for v in vals], dtype=np.uint32)


def _from_limbs16(arr):
    return [sum(int(x) << (16 * k) for k, x in enumerate(row))
            for row in np.asarray(arr).reshape(-1, 16)]


def _gl_words(rows):
    """Nested host ints < 2^64 -> int64 tensor with the same bits."""
    return torch.from_numpy(np.array(rows, dtype=np.uint64).view(np.int64))


def _gl_pair(rows):
    u = np.array(rows, dtype=np.uint64)
    return ((u >> np.uint64(32)).astype(np.uint32),
            (u & np.uint64(0xFFFFFFFF)).astype(np.uint32))


# ----------------------------------------------------------------------------
# constants
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["P_BN254", "WIDTH", "RATE", "FULL_ROUNDS",
                                  "PARTIAL_ROUNDS", "KAT_T3_HASH_1_2",
                                  "KAT_T4_HASH_1_2_3"])
def test_constants_copy_equals_original(name):
    assert getattr(tconst, name) == getattr(jconst, name)


def test_generated_tables_equal_original():
    assert tconst.generate() == jconst.generate()
    assert tconst.generate(t=3) == jconst.generate(t=3)


# ----------------------------------------------------------------------------
# Fr functions against the JAX ops/bn254.py
# ----------------------------------------------------------------------------

N_FR = 24


@pytest.fixture(scope="module")
def fr_case():
    a = _ints(1, N_FR)
    b = _ints(2, N_FR)
    wide = _ints(3, N_FR, bound=R, edge=(0, P, R - 1))       # any 256-bit
    near = [P - 2, P - 1, P, P + 1, R - 1, 0] + _ints(4, N_FR - 6, bound=R)
    g = np.array([[v & ((1 << 64) - 1) for v in _ints(5 + k, N_FR,
                                                      bound=1 << 64,
                                                      edge=(0, GL_P - 1,
                                                            (1 << 64) - 1))]
                  for k in range(3)], dtype=np.uint64).T     # (N, 3)

    def jax_side(a, b, wide, near, g_hi, g_lo):
        return {
            "mont_mul": jfr.mont_mul(a, b),
            "to_mont": jfr.to_mont(wide),
            "from_mont": jfr.from_mont(a),
            "is_canonical": jfr.is_canonical(near),
            "pack_goldilocks": jfr.pack_goldilocks(
                [(g_hi[:, k], g_lo[:, k]) for k in range(3)]),
            "to_goldilocks_56": jfr.to_goldilocks_56(wide),
        }

    g_hi, g_lo = _gl_pair(g)
    want = smart_jit(jax_side)(_limbs16(a), _limbs16(b), _limbs16(wide),
                               _limbs16(near), g_hi, g_lo)
    got = {
        "mont_mul": fr.mont_mul(fr.from_ints(a), fr.from_ints(b)),
        "to_mont": fr.to_mont(fr.from_ints(wide)),
        "from_mont": fr.from_mont(fr.from_ints(a)),
        "is_canonical": fr.is_canonical(fr.from_ints(near)),
        "pack_goldilocks": fr.pack_goldilocks(_gl_words(g)),
        "to_goldilocks_56": fr.to_goldilocks_56(fr.from_ints(wide)),
    }
    return got, want


@pytest.mark.parametrize("name", ["mont_mul", "to_mont", "from_mont",
                                  "pack_goldilocks"])
def test_fr_function_vs_jax(fr_case, name):
    got, want = fr_case
    assert fr.to_ints(got[name]) == _from_limbs16(want[name])


def test_is_canonical_vs_jax(fr_case):
    got, want = fr_case
    assert got["is_canonical"].tolist() == np.asarray(
        want["is_canonical"]).tolist()


def test_to_goldilocks_56_vs_jax(fr_case):
    got, want = fr_case
    jax_limbs = np.stack([(np.asarray(hi).astype(np.uint64) << np.uint64(32))
                          | np.asarray(lo).astype(np.uint64)
                          for hi, lo in want["to_goldilocks_56"]], axis=-1)
    np.testing.assert_array_equal(
        got["to_goldilocks_56"].numpy().view(np.uint64), jax_limbs)


def test_add_mod_and_to_mont_vs_host_ints():
    a, b = _ints(6, 16), _ints(7, 16)
    assert fr.to_ints(fr.add_mod(fr.from_ints(a), fr.from_ints(b))) == \
        [(x + y) % P for x, y in zip(a, b)]
    wide = _ints(8, 16, bound=R, edge=(R - 1, P, P + 5))
    assert fr.to_ints(fr.to_mont(fr.from_ints(wide))) == \
        [x * R % P for x in wide]


# ----------------------------------------------------------------------------
# the plain permutation and hashing against refimpl
# ----------------------------------------------------------------------------

def test_permute_known_answer():
    """circomlib / go-iden3-crypto poseidon([1, 2, 3]) on the t=4 instance."""
    out = tpb.permute(fr.from_ints([[0, 1, 2, 3]]))
    assert fr.to_ints(out)[0][0] == tconst.KAT_T4_HASH_1_2_3


def test_permute_vs_refimpl():
    states = [_ints(10 + i, 4) for i in range(5)] + [[P - 1] * 4]
    got = fr.to_ints(tpb.permute(fr.from_ints(states)))
    assert got == [ref.permute(s) for s in states]


def test_two_to_one_vs_refimpl():
    left = _ints(20, 6)
    right = _ints(21, 6, bound=R, edge=(P, R - 1))   # non-canonical too
    got = fr.to_ints(tpb.two_to_one(fr.from_ints(left), fr.from_ints(right)))
    assert got == [ref.two_to_one(x, y) for x, y in zip(left, right)]


def _gl_rows(seed, n, w):
    rng = random.Random(seed)
    rows = [[rng.randrange(1 << 64) for _ in range(w)] for _ in range(n)]
    rows[0] = [GL_P - 1] * w
    return rows


@pytest.mark.parametrize("w", [2, 3, 4, 9, 13, 32])
def test_hash_or_noop_vs_refimpl(w):
    rows = _gl_rows(30 + w, 4, w)
    got = fr.to_ints(tpb.hash_or_noop_gl(_gl_words(rows)))
    assert got == [ref.hash_or_noop(r) for r in rows]


# ----------------------------------------------------------------------------
# plain versions of K4, K5, K6 against refimpl
# ----------------------------------------------------------------------------

def _planes(vals_by_lane, rows):
    """[[int] * rows] per lane -> (4 * rows, N) word planes."""
    return fr.from_ints(vals_by_lane).reshape(len(vals_by_lane),
                                              4 * rows).T.contiguous()


def test_k6_plain_vs_refimpl():
    states = [_ints(40 + i, 4) for i in range(6)]
    mont = [[v * R % P for v in s] for s in states]
    out = bk.permute_planes_plain(_planes(mont, 4))
    got = fr.to_ints(out.T.reshape(-1, 4, 4))
    assert got == [[v * R % P for v in ref.permute(s)] for s in states]


@pytest.mark.parametrize("w", [2, 3, 4, 9, 13, 32])
def test_k5_plain_vs_refimpl(w):
    rows = _gl_rows(50 + w, 5, w)
    out = bk.hash_or_noop_mont_planes_plain(_gl_words(rows).T.contiguous())
    got = fr.to_ints(out.T.contiguous())
    assert got == [ref.hash_or_noop(r) * R % P for r in rows]


def _path_case(seed, n, d_max):
    """Leaves, siblings, indices and per-lane depths (mixed 0..d_max, both
    orientations), with one non-canonical sibling, and the roots refimpl's
    two_to_one gives along each path."""
    rng = random.Random(seed)
    leaves = [rng.randrange(P) for _ in range(n)]
    sibs = [[rng.randrange(P) for _ in range(n)] for _ in range(d_max)]
    sibs[0][1] = P + 12345                      # >= p: a tampered sibling
    idx = [rng.randrange(1 << d_max) for _ in range(n)]
    depth = [i % (d_max + 1) for i in range(n)]
    roots = []
    for i in range(n):
        h, ix = leaves[i], idx[i]
        for lvl in range(depth[i]):
            s = sibs[lvl][i]
            h = ref.two_to_one(s, h) if ix & 1 else ref.two_to_one(h, s)
            ix >>= 1
        roots.append(h)
    active = np.array([[int(lvl < depth[i]) for i in range(n)]
                       for lvl in range(d_max)], dtype=np.int32)
    return leaves, sibs, idx, active, roots


def test_k4_plain_vs_refimpl_mixed_depths():
    leaves, sibs, idx, active, roots = _path_case(60, 12, 3)
    assert set(active.sum(0).tolist()) == {0, 1, 2, 3}
    node = fr.from_ints([v * R % P for v in leaves]).T.contiguous()
    sib = fr.from_ints(sibs).permute(0, 2, 1).contiguous()      # (d, 4, N)
    out = bk.verify_paths_mont_planes_plain(
        node, sib, torch.tensor(idx, dtype=torch.int64),
        torch.from_numpy(active))
    assert fr.to_ints(out.T.contiguous()) == roots


# ----------------------------------------------------------------------------
# wrappers and the build
# ----------------------------------------------------------------------------

def test_wrappers_use_plain_on_cpu():
    x = _gl_words(_gl_rows(70, 3, 5)).T.contiguous()
    state = _planes([[v * R % P for v in _ints(71, 4)]] * 2, 4)
    before = (bk.hash_or_noop_mont_planes.launches, bk.permute_planes.launches)
    assert torch.equal(bk.hash_or_noop_mont_planes(x),
                       bk.hash_or_noop_mont_planes_plain(x))
    assert torch.equal(bk.permute_planes(state), bk.permute_planes_plain(state))
    assert (bk.hash_or_noop_mont_planes.launches,
            bk.permute_planes.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "device"])
def test_k4_wrapper_rejects_bad_inputs(bad):
    n, d = 4, 2
    node = torch.zeros((4, n), dtype=torch.int64)
    sib = torch.zeros((d, 4, n), dtype=torch.int64)
    idx = torch.zeros((n,), dtype=torch.int64)
    active = torch.ones((d, n), dtype=torch.int32)
    if bad == "dtype":
        active = active.long()
    elif bad == "shape":
        sib = sib[:, :3]
    elif bad == "contiguous":
        node = node.T.contiguous().T
    else:
        node = node.to("meta")
    with pytest.raises((TypeError, ValueError)):
        bk.verify_paths_mont_planes(node, sib, idx, active)


_HEADER_TEXTS = _build.header_texts()


@pytest.mark.parametrize("name,header", [
    (name, hdr) for name in sorted(_build.KERNELS)
    for hdr in sorted(_HEADER_TEXTS)])
def test_library_digest_covers_every_header(name, header):
    """A changed header (generated constants included) gives every library
    another file, so a stale build is never loaded."""
    texts = dict(_HEADER_TEXTS)
    base = _build.lib_path(name, texts)
    assert _build.lib_path(name, dict(texts)) == base
    texts[header] += "\n// changed\n"
    assert _build.lib_path(name, texts) != base


def test_library_digest_sees_every_include():
    """Every header a kernel source or header includes by name is one whose
    text the digest covers."""
    included = set()
    for path in _build.CSRC.iterdir():
        included.update(re.findall(r'#include "([^"]+)"', path.read_text()))
    assert included and included <= set(_HEADER_TEXTS)
