"""Poseidon over Goldilocks: the plain plane path, the dispatching plane
entry points and the batch-last bulk hashing API.

A plane state is a (12, N) int64 tensor: the state element on the leading
axis and N independent lanes after it, the layout of the JAX package's plane
path (`halo2_plonky2_verifier_tpu/ops/poseidon.py:187-304`).  The `*_plain`
functions are plain PyTorch and call only plain functions: they are what
every Goldilocks kernel of the port is held against (`ops/merkle_kernels.py`,
`ops/transcript_kernels.py`, `ops/poseidon_kernels.py`).  `permute_planes`
and the functions built on it dispatch: kernel K7 for a CUDA tensor, the
plain version for a CPU tensor, and no other switch (the JAX package's
2^17-lane threshold, `ops/poseidon.py:134-141` there, keeps XLA's fusion on
a TPU; eager PyTorch has no fusion to lose).

The batch-last API (`zero_state`, `permute`, `absorb`, `hash_no_pad`,
`hash_or_noop`, `two_to_one`) mirrors `ops/poseidon.py:144,310-377` of the
JAX package on (..., 12) or (..., k) int64 tensors: `permute` lays the
states out as contiguous (12, N) planes for K7 and back.

Round structure: constant layer -> S-box x^7 (all 12 elements in the 4 + 4
full rounds, element 0 in the 22 partial rounds) -> circulant MDS plus
DIAG[0].  The MDS entries are <= 41, so the mix is taken exactly on 32-bit
halves and reduced once per element.  `permute_planes_opt_plain` computes
the same permutation with plonky2's fast partial layer
(`constants/poseidon_goldilocks_opt.py`), the schedule the kernels' body
runs; it proves the tables in the tests, and no kernel is held against it.
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
from ..constants.poseidon_goldilocks_opt import opt_tables
from ..utils import profiling
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


@profiling.counted(profiling.gl_planes)
def permute_planes_plain(state):
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


@functools.lru_cache(maxsize=None)
def _opt_tables(device):
    """The fast schedule's tables as int64 tensors on `device`: first
    (12, 1), partial (22, 1, 1), init (11, 11, 1), w_hat and v (22, 11, 1)."""
    t = opt_tables()

    def tensor(x, *shape):
        flat = x if isinstance(x[0], int) else [v for row in x for v in row]
        return torch.tensor([gl.signed(v) for v in flat], dtype=torch.int64,
                            device=device).reshape(*shape)

    n = N_PARTIAL_ROUNDS
    return (tensor(t["first"], W, 1), tensor(t["partial"], n, 1, 1),
            tensor(t["init"], W - 1, W - 1, 1),
            tensor(t["w_hat"], n, W - 1, 1), tensor(t["v"], n, W - 1, 1))


def _field_sum(x):
    """Sum over the leading axis of canonical values, canonical."""
    acc = x[0]
    for k in range(1, x.shape[0]):
        acc = gl.add(acc, x[k])
    return acc


@profiling.counted(profiling.gl_planes)
def permute_planes_opt_plain(state):
    """`permute_planes_plain` through plonky2's fast partial layer: entry
    constants and the 11 x 11 entry matrix, then per partial round the
    S-box of element 0, its scalar constant and the sparse mix (row 0
    `w_hat`, column 0 `v`).  (12, N) int64 -> (12, N), canonical."""
    rc = _round_constants(state.device)
    first, partial, init, w_hat, v = _opt_tables(state.device)
    m00 = opt_tables()["m00"]
    r0 = HALF_N_FULL_ROUNDS
    r1 = HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS
    for r in range(r0):
        state = _mds_planes(_sbox(gl.add(state, rc[r])))
    state = gl.add(state, first)
    rest = _field_sum(gl.mul(init, state[None, 1:]).transpose(0, 1))
    state = torch.cat([state[:1], rest])
    for i in range(N_PARTIAL_ROUNDS):
        y = gl.add(_sbox(state[:1]), partial[i])
        new0 = gl.add(gl.mul_const_small(y, m00),
                      _field_sum(gl.mul(w_hat[i], state[1:]))[None])
        state = torch.cat([new0, gl.add(state[1:], gl.mul(v[i], y))])
    for r in range(r1, N_ROUNDS):
        state = _mds_planes(_sbox(gl.add(state, rc[r])))
    return state


def permute_planes(state):
    """(12, N) int64 -> the permuted (12, N) state: kernel K7 for a CUDA
    tensor, `permute_planes_plain` for a CPU tensor
    (`ops/poseidon_kernels.py`)."""
    from . import poseidon_kernels

    return poseidon_kernels.permute_planes(state)


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


def _two_to_one_state(left, right):
    return torch.cat([left, right, torch.zeros_like(left)])


def two_to_one_planes_plain(left, right):
    """left/right: (4, N) hash planes -> (4, N) compressed planes."""
    return permute_planes_plain(_two_to_one_state(left, right))[:4]


def two_to_one_planes(left, right):
    """`two_to_one_planes_plain` through `permute_planes` (K7 on the card)."""
    return permute_planes(_two_to_one_state(left, right))[:4]


# ----------------------------------------------------------------------------
# Batch-last sponge and hashing (plonky2 semantics)
# ----------------------------------------------------------------------------

def zero_state(shape=(), device="cuda"):
    """The all-zero (*shape, 12) int64 sponge state, on the card unless the
    caller asks for another device (device="cpu" runs the plain path)."""
    return torch.zeros(tuple(shape) + (W,), dtype=torch.int64, device=device)


def permute(state):
    """(..., 12) int64 -> the permuted (..., 12) states, canonical."""
    batch = state.shape[:-1]
    planes = state.reshape(-1, W).T.contiguous()         # (12, N)
    return permute_planes(planes).T.reshape(batch + (W,))


def _overwrite_prefix(state, chunk):
    """state[..., :k] = chunk, k = chunk.shape[-1]."""
    return torch.cat([chunk, state[..., chunk.shape[-1]:]], dim=-1)


def absorb(state, inputs):
    """Overwrite-mode rate-8 sponge absorb of (..., k) inputs: each full
    chunk of 8 overwrites state[..., :8] and permutes, then a remainder of
    k % 8 overwrites its prefix and permutes; k = 0 leaves the state as it
    is (reference: permutation.rs:286-301)."""
    k = inputs.shape[-1]
    for off in range(0, k, SPONGE_RATE):
        state = permute(_overwrite_prefix(state,
                                          inputs[..., off:off + SPONGE_RATE]))
    return state


def hash_no_pad(inputs):
    """(..., k) -> (..., 4): plonky2 hash_n_to_m_no_pad with 4 outputs."""
    state = zero_state(inputs.shape[:-1], inputs.device)
    return absorb(state, inputs)[..., :4]


def hash_or_noop(inputs):
    """(..., k) -> (..., 4): k <= 4 inputs are zero-padded to 4 with no
    permutation; wider inputs are sponged (reference: hash/mod.rs:109-119)."""
    k = inputs.shape[-1]
    if k <= 4:
        return torch.nn.functional.pad(inputs, (0, 4 - k))
    return hash_no_pad(inputs)


def two_to_one(left, right):
    """Compress two (..., 4) hashes: state[0:8] = left || right, one
    permutation, the first 4 outputs (reference: hash.rs:188-214)."""
    z = torch.zeros_like(left)
    return permute(torch.cat([left, right, z], dim=-1))[..., :4]


__all__ = ["SPONGE_RATE", "W", "permute_planes", "permute_planes_plain",
           "permute_planes_opt_plain",
           "hash_no_pad_planes", "hash_or_noop_planes", "two_to_one_planes",
           "two_to_one_planes_plain", "zero_state", "permute", "absorb",
           "hash_no_pad", "hash_or_noop", "two_to_one"]
