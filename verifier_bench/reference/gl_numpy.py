"""Goldilocks arithmetic and the Poseidon permutation on numpy uint64 arrays,
many states at once, and the plonky2 challenger run for many proofs at once.

The field operations are those of the pure-int reference's numpy module
(128-bit products from 32-bit halves, plonky2's `reduce128`).  The MDS layer
multiplies the state's 16-bit limbs by the 12 x 12 matrix in float64: every
entry is below 2^6 and a row's sum below 2^9, so a limb's row sum stays
below 2^25 and is exact, and the four limb sums are put together and reduced
once.  Everything else is the naive round structure: constants, S-box x^7 on
all 12 cells (full rounds) or on cell 0 (partial rounds), the dense MDS.
"""

import numpy as np

from .constants import (ALL_ROUND_CONSTANTS, HALF_N_FULL_ROUNDS,
                        MDS_MATRIX_CIRC, MDS_MATRIX_DIAG, N_PARTIAL_ROUNDS,
                        N_ROUNDS, SPONGE_RATE, SPONGE_WIDTH)

P_INT = (1 << 64) - (1 << 32) + 1
P = np.uint64(P_INT)
EPSILON = np.uint64((1 << 32) - 1)          # 2^64 mod p
_M32 = np.uint64(0xFFFFFFFF)
_M16 = np.uint64(0xFFFF)
_S16, _S32 = np.uint64(16), np.uint64(32)

_RC = np.array(ALL_ROUND_CONSTANTS, dtype=np.uint64).reshape(N_ROUNDS,
                                                             SPONGE_WIDTH)
_T = SPONGE_WIDTH
# column-major MDS for `limbs @ _MDS_T`: out[r] = sum_c M[r][c] s[c]
_MDS_T = np.array([[MDS_MATRIX_CIRC[(c - r) % _T]
                    + (MDS_MATRIX_DIAG[r] if r == c else 0)
                    for r in range(_T)] for c in range(_T)], dtype=np.float64)
_LIMB_SHIFTS = np.arange(4, dtype=np.uint64) * _S16


def _canon(s):
    return np.where(s >= P, s - P, s)


def add(a, b):
    s = a + b
    s = np.where(s < a, s + EPSILON, s)
    return _canon(s)


def reduce128(x_hi, x_lo):
    """x_hi 2^64 + x_lo mod p, canonical (2^64 = 2^32 - 1, 2^96 = -1)."""
    x_hi_hi = x_hi >> _S32
    x_hi_lo = x_hi & _M32
    t0 = x_lo - x_hi_hi
    t0 = np.where(x_lo < x_hi_hi, t0 - EPSILON, t0)
    t1 = x_hi_lo * EPSILON
    s = t0 + t1
    s = np.where(s < t0, s + EPSILON, s)
    return _canon(s)


def mul(a, b):
    a_lo, a_hi = a & _M32, a >> _S32
    b_lo, b_hi = b & _M32, b >> _S32
    lo = a_lo * b_lo
    m1 = a_lo * b_hi
    m2 = a_hi * b_lo
    hi = a_hi * b_hi
    t = (lo >> _S32) + (m1 & _M32) + (m2 & _M32)
    prod_lo = (lo & _M32) | ((t & _M32) << _S32)
    prod_hi = hi + (m1 >> _S32) + (m2 >> _S32) + (t >> _S32)
    return reduce128(prod_hi, prod_lo)


def sbox7(x):
    x2 = mul(x, x)
    x4 = mul(x2, x2)
    return mul(mul(x4, x2), x)


def mds(state):
    """(N, 12) canonical -> (N, 12) M s mod p."""
    n = state.shape[0]
    limbs = np.stack([(state >> sh) & _M16 for sh in _LIMB_SHIFTS])
    sums = (limbs.reshape(4 * n, _T).astype(np.float64) @ _MDS_T)
    sums = sums.astype(np.uint64).reshape(4, n, _T)           # exact, < 2^25
    low = sums[0] + (sums[1] << _S16)                          # < 2^42
    high = sums[2] + (sums[3] << _S16)                         # x 2^32
    x_lo = low + ((high & _M32) << _S32)
    carry = (x_lo < low).astype(np.uint64)
    return reduce128((high >> _S32) + carry, x_lo)


def permute(state):
    """(N, 12) uint64 canonical states -> their Poseidon permutations."""
    s = np.array(state, dtype=np.uint64, copy=True)
    for rnd in range(N_ROUNDS):
        s = add(s, _RC[rnd])
        if HALF_N_FULL_ROUNDS <= rnd < HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS:
            s[:, 0] = sbox7(s[:, 0])
        else:
            s = sbox7(s)
        s = mds(s)
    return s


def hash_or_noop(leaves):
    """(N, k) -> (N, 4): plonky2 `hash_or_noop` (k <= 4: the leaf padded
    with zeros; else the overwrite-mode sponge, rate 8, zero state)."""
    n, k = leaves.shape
    if k <= 4:
        out = np.zeros((n, 4), dtype=np.uint64)
        out[:, :k] = leaves
        return out
    state = np.zeros((n, _T), dtype=np.uint64)
    for i in range(0, k, SPONGE_RATE):
        chunk = leaves[:, i:i + SPONGE_RATE]
        state[:, :chunk.shape[1]] = chunk
        state = permute(state)
    return state[:, :4]


def two_to_one(left, right):
    """(N, 4), (N, 4) -> (N, 4): one permutation of left || right || 0."""
    state = np.zeros((left.shape[0], _T), dtype=np.uint64)
    state[:, 0:4] = left
    state[:, 4:8] = right
    return permute(state)[:, :4]


class Challenger:
    """plonky2's Challenger (the duplex sponge of `challenger/mod.rs`) run
    for N proofs at once: every proof observes the same number of elements
    in the same order, so the sponge steps are the same and only the values
    differ.  Observed values are (N,) uint64 arrays, reduced mod p as the
    permutation's input; a challenge is an (N,) array."""

    def __init__(self, n):
        self.state = np.zeros((n, _T), dtype=np.uint64)
        self.inputs = []
        self.outputs = []

    def observe(self, columns):
        """Observe (N, k) elements, column by column."""
        self.outputs = []
        cols = np.asarray(columns, dtype=np.uint64)
        self.inputs.extend(_canon(cols[:, j]) for j in range(cols.shape[1]))

    def _duplex(self):
        for i in range(0, len(self.inputs), SPONGE_RATE):
            for j, col in enumerate(self.inputs[i:i + SPONGE_RATE]):
                self.state[:, j] = col
            self.state = permute(self.state)
        self.outputs = [self.state[:, j].copy() for j in range(SPONGE_RATE)]
        self.inputs = []

    def challenge(self):
        if self.inputs:
            self._duplex()
        elif not self.outputs:
            self.state = permute(self.state)
            self.outputs = [self.state[:, j].copy()
                            for j in range(SPONGE_RATE)]
        return self.outputs.pop()

    def ext_challenge(self):
        a = self.challenge()
        b = self.challenge()
        return a, b
