"""The PyTorch port's Poseidon plane path and the plain versions of kernels
K1 (Merkle paths) and K3 (leaf sponge), against the JAX package: its jnp
plane functions, and its Pallas kernels run in interpret mode with groups=1
as tests/test_pallas_fused.py runs them.

Integer results: the tolerance is 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from halo2_plonky2_verifier_tpu import fri as jfri
from halo2_plonky2_verifier_tpu.constants import poseidon_goldilocks as jconst
from halo2_plonky2_verifier_tpu.ops import goldilocks as jgl
from halo2_plonky2_verifier_tpu.ops import merkle_pallas
from halo2_plonky2_verifier_tpu.ops import poseidon as jpos
from halo2_plonky2_verifier_tpu.refimpl import poseidon as pos_ref
from halo2_plonky2_verifier_tpu.utils.compile import smart_jit
from halo2_plonky2_verifier_tpu_torch.constants import poseidon_goldilocks as tconst
from halo2_plonky2_verifier_tpu_torch.ops import goldilocks as tgl
from halo2_plonky2_verifier_tpu_torch.ops import merkle_kernels as mk
from halo2_plonky2_verifier_tpu_torch.ops import poseidon as tpos

P = tgl.P


def _rand(seed, shape, noncanonical=False):
    rng = np.random.default_rng(seed)
    hi = (1 << 64) if noncanonical else P
    x = rng.integers(0, hi, size=shape, dtype=np.uint64)
    flat = x.reshape(-1)
    flat[:3] = [0, P - 1, (1 << 64) - 1 if noncanonical else 1]
    return x


def _same(torch_out, jax_out):
    np.testing.assert_array_equal(tgl.to_u64(torch_out), jgl.to_u64(jax_out))


@pytest.mark.parametrize("name", [
    "SPONGE_WIDTH", "SPONGE_RATE", "HALF_N_FULL_ROUNDS", "N_PARTIAL_ROUNDS",
    "N_ROUNDS", "MDS_MATRIX_CIRC", "MDS_MATRIX_DIAG", "ALL_ROUND_CONSTANTS",
    "KAT_VECTORS", "KAT_RANGE_FIRST_OUT", "GOLDILOCKS_PRIME"])
def test_constants_copy_equals_original(name):
    assert getattr(tconst, name) == getattr(jconst, name)


def test_permute_known_answers():
    zero_in, zero_out = tconst.KAT_VECTORS[0]
    state = tgl.from_u64(np.array([zero_in, list(range(12))],
                                  dtype=np.uint64).T)          # (12, 2)
    out = tgl.to_u64(tpos.permute_planes(state))
    assert [int(v) for v in out[:, 0]] == zero_out
    assert int(out[0, 1]) == tconst.KAT_RANGE_FIRST_OUT
    assert [int(v) for v in out[:, 1]] == pos_ref.permute(list(range(12)))


def test_permute_planes_vs_jax():
    x = _rand(1, (12, 64), noncanonical=True)
    _same(tpos.permute_planes(tgl.from_u64(x)),
          smart_jit(jpos.permute_planes)(jgl.from_u64(x)))


def test_two_to_one_planes_vs_jax():
    left, right = _rand(2, (4, 48)), _rand(3, (4, 48))
    _same(tpos.two_to_one_planes(tgl.from_u64(left), tgl.from_u64(right)),
          smart_jit(jpos.two_to_one_planes)(jgl.from_u64(left),
                                            jgl.from_u64(right)))


@pytest.mark.parametrize("w", [5, 8, 9, 32])
def test_hash_no_pad_plain_vs_jax(w):
    x = _rand(10 + w, (w, 40))
    _same(mk.hash_no_pad_planes(tgl.from_u64(x)),
          smart_jit(jpos.hash_no_pad_planes)(jgl.from_u64(x)))


@pytest.mark.parametrize("w", [2, 4, 5])
def test_hash_or_noop_planes_vs_refimpl(w):
    x = _rand(20 + w, (w, 6))
    got = tgl.to_u64(tpos.hash_or_noop_planes(tgl.from_u64(x)))
    for i in range(x.shape[1]):
        want = pos_ref.hash_or_noop([int(v) for v in x[:, i]])
        assert [int(v) for v in got[:, i]] == want


def test_hash_no_pad_plain_vs_pallas_interpret():
    # one partial chunk: interpret mode takes tens of seconds of CPU time per
    # permutation, and the multi-chunk widths are held against the jnp planes
    x = _rand(30, (5, 128))
    want = merkle_pallas.hash_no_pad_planes(jgl.from_u64(x), interpret=True,
                                            groups=1)
    _same(mk.hash_no_pad_planes_plain(tgl.from_u64(x)), want)


def _paths(seed, n, d_max):
    """Seeded path inputs whose active levels form a prefix of random depth
    (0..d_max) per lane, as the verifier's padded depths do."""
    rng = np.random.default_rng(seed)
    node = _rand(seed, (4, n))
    sib = _rand(seed + 1, (d_max, 4, n))
    idx = rng.integers(0, 1 << d_max, size=n).astype(np.uint32)
    depth = rng.integers(0, d_max + 1, size=n)
    active = (np.arange(d_max)[:, None] < depth[None, :]).astype(np.uint32)
    return node, sib, idx, active


def _t_paths(node, sib, idx, active):
    return (tgl.from_u64(node), tgl.from_u64(sib),
            torch.from_numpy(idx.astype(np.int64)),
            torch.from_numpy(active.astype(np.int32)))


def test_merkle_paths_plain_vs_pallas_interpret():
    node, sib, idx, active = _paths(40, 128, 3)
    want = merkle_pallas.verify_paths_planes(
        jgl.from_u64(node), jgl.from_u64(sib), jnp.asarray(idx),
        jnp.asarray(active), interpret=True, groups=1)
    _same(mk.verify_paths_planes_plain(*_t_paths(node, sib, idx, active)),
          want)


def test_merkle_paths_shift_every_level_vs_jax_scan():
    """K1 shifts the index on every level (as the Pallas kernel does); the
    JAX scan shifts it only where the level is active.  With active levels
    forming a prefix per lane, both give the same root."""
    node, sib, idx, active = _paths(50, 96, 4)
    assert (active[:, (active[0] == 0)] == 0).all()     # mixed depths, 0 too
    assert len(set(active.sum(0).tolist())) == 5
    scan = smart_jit(jfri.merkle_scan_planes)
    want = scan(jgl.from_u64(node), jnp.asarray(idx), jgl.from_u64(sib),
                jnp.asarray(active))
    _same(mk.verify_paths_planes(*_t_paths(node, sib, idx, active)), want)


def test_merkle_paths_vs_refimpl_tree():
    """A real tree: the path from each leaf must reach the root of the
    refimpl's Merkle tree built over the same leaves."""
    from halo2_plonky2_verifier_tpu.refimpl.hashers import GOLDILOCKS

    depth = 3
    leaves = _rand(60, (1 << depth, 4))
    levels = [[list(map(int, leaf)) for leaf in leaves]]
    while len(levels[-1]) > 1:
        prev = levels[-1]
        levels.append([GOLDILOCKS.two_to_one(prev[2 * i], prev[2 * i + 1])
                       for i in range(len(prev) // 2)])
    n = 1 << depth
    sib = np.zeros((depth, 4, n), dtype=np.uint64)
    for i in range(n):
        j = i
        for lvl in range(depth):
            sib[lvl, :, i] = levels[lvl][j ^ 1]
            j >>= 1
    root = mk.verify_paths_planes(
        tgl.from_u64(leaves.T.copy()), tgl.from_u64(sib),
        torch.arange(n, dtype=torch.int64),
        torch.ones((depth, n), dtype=torch.int32))
    assert (tgl.to_u64(root).T == np.array(levels[-1][0], dtype=np.uint64)).all()


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "device"])
def test_wrappers_reject_bad_inputs(bad):
    node, sib, idx, active = _t_paths(*_paths(70, 8, 2))
    if bad == "dtype":
        idx = idx.to(torch.int32)
    elif bad == "shape":
        sib = sib[:, :3]
    elif bad == "contiguous":
        node = node.T.contiguous().T
    else:
        node = node.to("meta")
    with pytest.raises((TypeError, ValueError)):
        mk.verify_paths_planes(node, sib, idx, active)


def test_hash_no_pad_wrapper_uses_plain_on_cpu():
    x = tgl.from_u64(_rand(80, (9, 16)))
    before = mk.hash_no_pad_planes.launches
    assert torch.equal(mk.hash_no_pad_planes(x), mk.hash_no_pad_planes_plain(x))
    assert mk.hash_no_pad_planes.launches == before     # no kernel on the CPU
