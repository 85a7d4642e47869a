"""plonky2's fast partial-round schedule of the Poseidon-Goldilocks
permutation, derived from the port's copy of the base constants.

`derive_fast_partial_round_constants` (with `mds_matrix` and `_mat_inv`) is a
copy of the derivation in
`halo2_plonky2_verifier_tpu/constants/poseidon_goldilocks.py` (the JAX
package's `__init__` imports jax, so the port cannot import it from there);
`tests/test_torch_gl_opt.py` asserts that both give the same values and that
they start with plonky2's own tables.  `fast_partial_matrices` extends it to
the matrices of plonky2's fast partial layer.

The schedule computes the same permutation as the naive one (constant layer,
S-box, dense MDS every round), re-associated:

  full rounds 0..3:     as the naive schedule;
  partial layer entry:  add FIRST (12 values) to the state, then
                        state[1:] = INIT @ state[1:] (INIT is 11 x 11);
  partial rounds i:     y = sbox(state[0]) + PARTIAL[i], then the sparse mix
                        state[0] = M00 y + sum_k W_HAT[i][k-1] state[k],
                        state[k] = state[k] + V[i][k-1] y   (k = 1..11);
  full rounds 26..29:   as the naive schedule.

Matrices act on columns (state' = M @ state).  Each partial round's dense
matrix D = [[d00, v^T], [w, D_hat]] factors as S @ diag(1, D_hat), with S
sparse: row 0 [d00, v^T D_hat^-1] (W_HAT), column 0 w (V) and the identity
elsewhere.  diag(1, D_hat) touches no element that the partial S-box or its
scalar constant touches, so it moves to the round before, where it makes
that round's dense matrix diag(1, D_hat) @ M, and from the first partial
round to the entry of the layer (INIT).  d00 stays M[0][0] = 25 in every
round.  The round constants move backward through M^-1 in the same way, so
a partial round keeps one scalar constant.
"""

import functools

from .poseidon_goldilocks import (
    ALL_ROUND_CONSTANTS,
    GOLDILOCKS_PRIME as P,
    HALF_N_FULL_ROUNDS,
    MDS_MATRIX_CIRC,
    MDS_MATRIX_DIAG,
    N_PARTIAL_ROUNDS,
    N_ROUNDS,
    SPONGE_WIDTH,
)

_T = SPONGE_WIDTH

# plonky2's hardcoded tables start with these values (the JAX package's
# validation prefixes, constants/poseidon_goldilocks.py there).
FAST_PARTIAL_FIRST_ROUND_CONSTANT_PREFIX = [
    0x3cc3f892184df408, 0xe993fd841e7e97f1, 0xf2831d3575f0f3af,
    0xd2500e0a350994ca,
]
FAST_PARTIAL_ROUND_CONSTANTS_PREFIX = [0x74cb2e819ae421ab]
# ... and the matrices' (plonky2 poseidon_goldilocks.rs): W_HATS[0][0],
# VS[0][0], and FAST_PARTIAL_ROUND_INITIAL_MATRIX[0][:2], whose rows are the
# columns of `init` below (plonky2 stores that matrix transposed).
FAST_PARTIAL_ROUND_W_HATS_PREFIX = [0x3d999c961b7c63b0]
FAST_PARTIAL_ROUND_VS_PREFIX = [0x94877900674181c3]
FAST_PARTIAL_ROUND_INITIAL_MATRIX_PREFIX = [0x80772dc2645b280b,
                                            0xdc927721da922cf8]


def mds_matrix():
    """Dense 12x12 MDS: M[r][c] = circ[(c - r) % 12] + diag[r] * (r == c)."""
    return [[MDS_MATRIX_CIRC[(c - r) % _T]
             + (MDS_MATRIX_DIAG[r] if r == c else 0) for c in range(_T)]
            for r in range(_T)]


def _mat_inv(m):
    """Gauss-Jordan over GF(P)."""
    n = len(m)
    a = [[x % P for x in row] + [int(i == j) for j in range(n)]
         for i, row in enumerate(m)]
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r][col] % P)
        a[col], a[piv] = a[piv], a[col]
        inv = pow(a[col][col], P - 2, P)
        a[col] = [x * inv % P for x in a[col]]
        for r in range(n):
            if r != col and a[r][col] % P:
                f = a[r][col]
                a[r] = [(x - f * y) % P for x, y in zip(a[r], a[col])]
    return [row[n:] for row in a]


def derive_fast_partial_round_constants():
    """plonky2's FAST_PARTIAL_FIRST_ROUND_CONSTANT (12 values) and
    FAST_PARTIAL_ROUND_CONSTANTS (22 values, the last 0), from the base
    table: each partial round's constant vector folds backward through
    M^-1, so that a partial round needs one constant, on element 0, added
    after its S-box."""
    r_f = HALF_N_FULL_ROUNDS
    m_inv = _mat_inv(mds_matrix())
    ct = [list(ALL_ROUND_CONSTANTS[i * _T:(i + 1) * _T])
          for i in range(N_ROUNDS)]
    for i in range(N_ROUNDS - 2 - r_f, r_f - 1, -1):
        folded = [sum(m_inv[r][c] * ct[i + 1][c] for c in range(_T)) % P
                  for r in range(_T)]
        ct[i] = [(a + b) % P for a, b in zip(ct[i], [0] + folded[1:])]
        ct[i + 1] = [folded[0]] + [0] * (_T - 1)
    first = ct[r_f]
    partial = [ct[i][0] for i in range(r_f + 1, r_f + N_PARTIAL_ROUNDS)] + [0]
    return first, partial


@functools.lru_cache(maxsize=None)
def fast_partial_matrices():
    """(init, w_hat, v): init the 11 x 11 matrix applied to state[1:] at the
    entry of the partial layer (row-major: new[1 + r] = sum_c init[r][c]
    state[1 + c]); w_hat[i] and v[i] (11 values each) partial round i's
    sparse row 0 and column 0, as described in the module docstring."""
    m = mds_matrix()
    w_hat = [None] * N_PARTIAL_ROUNDS
    v = [None] * N_PARTIAL_ROUNDS
    dense = m
    for i in range(N_PARTIAL_ROUNDS - 1, -1, -1):
        row = dense[0][1:]
        d_hat = [r[1:] for r in dense[1:]]
        d_inv = _mat_inv(d_hat)
        w_hat[i] = [sum(row[a] * d_inv[a][b] for a in range(_T - 1)) % P
                    for b in range(_T - 1)]
        v[i] = [dense[k][0] for k in range(1, _T)]
        init = d_hat
        # the previous round's dense matrix: diag(1, d_hat) @ m
        dense = [m[0]] + [[sum(d_hat[k - 1][j - 1] * m[j][c]
                               for j in range(1, _T)) % P for c in range(_T)]
                          for k in range(1, _T)]
    return init, w_hat, v


@functools.lru_cache(maxsize=None)
def opt_tables():
    """The schedule's tables, plain field values (host ints):
    first    12 values added at the entry of the partial layer;
    partial  22 scalars, partial round i's constant after its S-box;
    init     the 11 x 11 entry matrix; w_hat, v  22 rows of 11 each;
    m00      M[0][0], row 0's weight of element 0 in every partial round."""
    first, partial = derive_fast_partial_round_constants()
    init, w_hat, v = fast_partial_matrices()
    return {"first": list(first), "partial": list(partial),
            "init": [list(r) for r in init],
            "w_hat": [list(r) for r in w_hat], "v": [list(r) for r in v],
            "m00": mds_matrix()[0][0]}

