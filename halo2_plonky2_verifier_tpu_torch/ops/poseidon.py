"""Poseidon over Goldilocks in plane layout, plain PyTorch.

A state is a (12, N) int64 tensor: the state element on the leading axis and
N independent lanes after it, the layout of the JAX package's plane path
(`halo2_plonky2_verifier_tpu/ops/poseidon.py:187-304`).  These functions are
the plain versions that every Goldilocks kernel of the port is held against
(`ops/merkle_kernels.py`, `ops/transcript_kernels.py`).

Round structure: constant layer -> S-box x^7 (all 12 elements in the 4 + 4
full rounds, element 0 in the 22 partial rounds) -> circulant MDS plus
DIAG[0].  The MDS entries are <= 41, so the mix is taken exactly on 32-bit
halves and reduced once per element.
"""

import functools

import torch

from ..constants.poseidon_goldilocks import (
    ALL_ROUND_CONSTANTS,
    HALF_N_FULL_ROUNDS,
    MDS_MATRIX_CIRC,
    MDS_MATRIX_DIAG,
    N_PARTIAL_ROUNDS,
    N_ROUNDS,
    SPONGE_RATE,
    SPONGE_WIDTH,
)
from . import goldilocks as gl

W = SPONGE_WIDTH
_M32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _round_constants(device):
    """(N_ROUNDS, 12, 1) int64 round constants on `device`."""
    rc = [gl.signed(c) for c in ALL_ROUND_CONSTANTS]
    return torch.tensor(rc, dtype=torch.int64,
                        device=device).reshape(N_ROUNDS, W, 1)


def _sbox(x):
    x2 = gl.mul(x, x)
    x4 = gl.mul(x2, x2)
    x6 = gl.mul(x4, x2)
    return gl.mul(x6, x)


def _mds_planes(state):
    """out[r] = sum_i CIRC[i] * state[(r + i) % 12] + DIAG[r] * state[r]."""
    lo = state & _M32
    hi = gl._shr(state, 32)
    acc_lo = lo * MDS_MATRIX_CIRC[0]
    acc_hi = hi * MDS_MATRIX_CIRC[0]
    for i in range(1, W):
        acc_lo = acc_lo + torch.roll(lo, -i, 0) * MDS_MATRIX_CIRC[i]
        acc_hi = acc_hi + torch.roll(hi, -i, 0) * MDS_MATRIX_CIRC[i]
    d0 = MDS_MATRIX_DIAG[0]        # the only nonzero diagonal entry
    acc_lo = torch.cat([acc_lo[:1] + lo[:1] * d0, acc_lo[1:]])
    acc_hi = torch.cat([acc_hi[:1] + hi[:1] * d0, acc_hi[1:]])
    # exact sum = acc_hi * 2^32 + acc_lo, both < 2^42
    mid = acc_hi + (acc_lo >> 32)
    lo64 = (acc_lo & _M32) | (mid << 32)
    return gl.reduce128(mid >> 32, lo64)


def permute_planes(state):
    """(12, N) int64 -> the permuted (12, N) state, canonical."""
    rc = _round_constants(state.device)
    r0 = HALF_N_FULL_ROUNDS
    r1 = HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS
    for r in range(N_ROUNDS):
        state = gl.add(state, rc[r])
        if r0 <= r < r1:
            state = torch.cat([_sbox(state[:1]), state[1:]])
        else:
            state = _sbox(state)
        state = _mds_planes(state)
    return state


def hash_no_pad_planes(inputs):
    """(w, N) -> (4, N): plonky2 hash_n_to_m_no_pad, overwrite-mode rate-8
    absorb.  Runs kernel K3 for a CUDA tensor, its plain version for a CPU
    tensor (`ops/merkle_kernels.py`)."""
    from . import merkle_kernels

    return merkle_kernels.hash_no_pad_planes(inputs)


def hash_or_noop_planes(inputs):
    """plonky2 hash_or_noop: <= 4 input rows are zero-padded to 4; wider
    inputs are sponged."""
    w = inputs.shape[0]
    if w <= 4:
        return torch.nn.functional.pad(inputs, (0, 0, 0, 4 - w))
    return hash_no_pad_planes(inputs)


def two_to_one_planes(left, right):
    """left/right: (4, N) hash planes -> (4, N) compressed planes."""
    state = torch.cat([left, right, torch.zeros_like(left)])
    return permute_planes(state)[:4]


__all__ = ["SPONGE_RATE", "W", "permute_planes", "hash_no_pad_planes",
           "hash_or_noop_planes", "two_to_one_planes"]
