"""The hash backends of the verifier (HasherChip analog).

Under both hashers a hash is a (..., 4) int64 tensor: four Goldilocks
elements ("poseidon_goldilocks"), or the four little-endian u64 words of one
BN254 Fr element ("poseidon_bn254").  So cap gathers, equality and stacking
are shared.  A backend holds everything else that depends on the hasher:
how the JAX package stores a hash array, its range check, how a hash is
observed by the Fiat-Shamir transcript, and the two Merkle kernels (leaf
hash, path walk).  Counterpart of `GLHashOps`, `BN254HashOps` and
`_take_cap_raw` in `halo2_plonky2_verifier_tpu/hashing.py`.
"""

import numpy as np
import torch

from .ops import bn254 as fr
from .ops import bn254_kernels
from .ops import goldilocks as gl
from .ops import merkle_kernels
from .ops import poseidon


def take_cap(caps, cap_index):
    """caps (B, S, cap, 4), cap_index (B, Q) -> (B, Q, S, 4): the cap entry
    each query's path must reach (select_from_idx over the Merkle cap).
    A gather, where the JAX package takes a one-hot mask-sum; the results
    agree for every index below the cap size, which the verifier's top-bit
    cap index always is."""
    b = caps.shape[0]
    rows = torch.arange(b, device=caps.device)[:, None]
    return caps[rows, :, cap_index]


def pack_hi_lo(hi, lo):
    """(hi, lo) uint32 arrays of the JAX package -> uint64 (hi << 32) | lo."""
    if hi.shape != lo.shape:
        raise ValueError(f"hi/lo shape mismatch {hi.shape} {lo.shape}")
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def split_hi_lo(u):
    """uint64 array -> the JAX package's (hi, lo) uint32 pair (the inverse
    of `pack_hi_lo`)."""
    u = np.asarray(u, dtype=np.uint64)
    return ((u >> np.uint64(32)).astype(np.uint32),
            (u & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def unpack_bn254_limbs(words):
    """(..., 4) uint64 little-endian words -> the JAX package's (..., 16)
    uint32 leaf of 16-bit limbs (the inverse of `pack_bn254_limbs`)."""
    w = np.asarray(words, dtype=np.uint64)[..., None]
    shifts = np.arange(4, dtype=np.uint64) * np.uint64(16)
    limbs = (w >> shifts) & np.uint64(0xFFFF)
    return (limbs.reshape(w.shape[:-2] + (16,)).astype(np.uint32),)


def pack_bn254_limbs(limbs):
    """(..., 16) uint32 16-bit limbs of a BN254 element -> (..., 4) uint64
    little-endian words."""
    if limbs.shape[-1:] != (16,):
        raise ValueError(f"BN254 hash leaf: expected (..., 16) limbs, got "
                         f"{limbs.shape}")
    q = limbs.astype(np.uint64).reshape(limbs.shape[:-1] + (4, 4))
    return (q[..., 0] | (q[..., 1] << np.uint64(16))
            | (q[..., 2] << np.uint64(32)) | (q[..., 3] << np.uint64(48)))


class GLHashOps:
    name = "poseidon_goldilocks"

    take_cap = staticmethod(take_cap)

    # a hash array is a (hi, lo) pair of leaves of the JAX ProofBatch pytree
    jax_leaves = 2
    from_jax_leaves = staticmethod(pack_hi_lo)
    to_jax_leaves = staticmethod(split_hi_lo)

    # Merkle leaves: (w, N) -> (4, N) hashes (K3 for w > 4); paths: node
    # (4, N), siblings (d_max, 4, N), idx (N,), active (d_max, N) -> roots
    # (4, N) (K1)
    leaf_hash = staticmethod(poseidon.hash_or_noop_planes)
    verify_paths = staticmethod(merkle_kernels.verify_paths_planes)

    @staticmethod
    def eq(a, b):
        return (a == b).all(dim=-1)

    @staticmethod
    def stack(hashes, dim):
        return torch.stack(hashes, dim=dim)

    @staticmethod
    def to_gl_elements(h):
        """(..., 4) hash -> (..., 4) Goldilocks elements in observation
        order (hash/mod.rs:12-18): the hash itself."""
        return h

    @staticmethod
    def canonical_ok(h):
        """(..., 4) -> (..., 4) bool: each element < p_gl."""
        return gl.is_canonical(h)


class BN254HashOps(GLHashOps):
    name = "poseidon_bn254"

    # a hash array is one (..., 16) leaf of 16-bit limbs
    jax_leaves = 1
    from_jax_leaves = staticmethod(pack_bn254_limbs)
    to_jax_leaves = staticmethod(unpack_bn254_limbs)

    # the leaf hashes come out of K5 in Montgomery form and stay so through
    # the level loop of K4, which returns standard-form roots (the JAX
    # package's `_bn254_merkle_planes_verdict`)
    leaf_hash = staticmethod(bn254_kernels.hash_or_noop_mont_planes)
    verify_paths = staticmethod(bn254_kernels.verify_paths_mont_planes)

    @staticmethod
    def to_gl_elements(h):
        """(..., 4) Fr words -> (..., 5) Goldilocks elements: the 56-bit
        limbs of decompose_le(x, 56, 5) (hash.rs:30-43)."""
        return fr.to_goldilocks_56(h)

    @staticmethod
    def canonical_ok(h):
        """(..., 4) Fr words -> (...,) bool: the element < p_bn254."""
        return fr.is_canonical(h)


def get_hash_ops(name):
    if name == "poseidon_goldilocks":
        return GLHashOps
    if name == "poseidon_bn254":
        return BN254HashOps
    raise ValueError(f"unknown hasher {name!r}")
