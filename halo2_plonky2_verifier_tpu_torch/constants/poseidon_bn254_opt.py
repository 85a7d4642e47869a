"""The optimized (go-iden3 / plonky2x) schedule of the Poseidon-BN254
permutation, derived from the port's copy of the base constants.

A copy of the derivation in
`halo2_plonky2_verifier_tpu/refimpl/poseidon_bn254_opt.py` (the JAX package's
`__init__` imports jax, so the port cannot import it from there);
`tests/test_torch_bn254_opt.py` asserts that both give the same tables.

The schedule computes the same permutation as the naive one (ark, S-box,
dense MDS every round), re-associated:

  entry full rounds r = 0..3:  add F[r], S-box every element, mix with M
                               (rounds 0..2), and for r = 3 add T after the
                               S-box and mix with the dense P instead;
  partial rounds i = 0..55:    S-box element 0, add the scalar gammas[i] to
                               it, then the sparse mix of round i:
                               new0 = row0 . s, new_k = s_k + col0[k-1] s0;
  exit full rounds j = 0..3:   S-box every element, add E[j] (j = 0..2), mix
                               with M.

Matrices act on columns (state' = M @ state).  The derivation factors each
partial round's dense matrix into a sparse one and a dense part that moves
backward through the S-box of lane 0, leaving one dense P at the transition;
round constants move backward the same way, so only lane 0's stays in a
partial round.
"""

import functools

from .poseidon_bn254 import FULL_ROUNDS, P_BN254 as P, PARTIAL_ROUNDS, WIDTH
from .poseidon_bn254 import generate

_T = WIDTH
HALF = FULL_ROUNDS // 2
ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS


def _mat_vec(a, x):
    return [sum(a[i][j] * x[j] for j in range(len(x))) % P
            for i in range(len(a))]


def _mat_mul(a, b):
    return [[sum(a[i][k] * b[k][j] for k in range(len(b))) % P
             for j in range(len(b[0]))] for i in range(len(a))]


def _mat_inv(a):
    """Gauss-Jordan over GF(P)."""
    n = len(a)
    aug = [[a[i][j] % P for j in range(n)] + [int(j == i) for j in range(n)]
           for i in range(n)]
    for col in range(n):
        piv = next(r for r in range(col, n) if aug[r][col] % P)
        aug[col], aug[piv] = aug[piv], aug[col]
        inv = pow(aug[col][col], P - 2, P)
        aug[col] = [x * inv % P for x in aug[col]]
        for r in range(n):
            if r != col and aug[r][col]:
                f = aug[r][col]
                aug[r] = [(aug[r][j] - f * aug[col][j]) % P
                          for j in range(2 * n)]
    return [row[n:] for row in aug]


def _sparse_to_dense(row0, col0):
    """[[row0], [col0[k-1], e_k]] as a dense t x t matrix."""
    m = [[0] * _T for _ in range(_T)]
    m[0] = list(row0)
    for k in range(1, _T):
        m[k][0] = col0[k - 1]
        m[k][k] = 1
    return m


@functools.lru_cache(maxsize=None)
def opt_tables():
    """(F, T_vec, gammas, E, P_mat, sparse, M), as the reference's
    `opt_tables()`:
    F       HALF t-vectors, the entry rounds' pre-S-box constants;
    T_vec   the t-vector added after the S-box of entry round HALF - 1;
    gammas  PARTIAL_ROUNDS scalars added to lane 0 after its S-box;
    E       HALF - 1 t-vectors, the exit rounds' post-S-box constants;
    P_mat   the dense transition matrix;
    sparse  PARTIAL_ROUNDS (row0, col0) pairs: row0 has t entries, col0 t - 1;
    M       the MDS."""
    c, m = generate()
    cr = [c[r * _T:(r + 1) * _T] for r in range(ROUNDS)]

    # Matrices, from the last partial round back: D_i = M''_i @ M'_i with
    # M'_i = diag(1, M_hat_i) and M''_i sparse; M'_i merges into the round
    # before (D_{i-1} = M'_i @ M), and M'_0 into the transition: P = M'_0 @ M.
    sparse = [None] * PARTIAL_ROUNDS
    twist = [None] * PARTIAL_ROUNDS                      # M'_i
    dense = m
    for i in range(PARTIAL_ROUNDS - 1, -1, -1):
        v = [dense[0][j] for j in range(1, _T)]
        w = [dense[k][0] for k in range(1, _T)]
        m_hat = [[dense[k][j] for j in range(1, _T)] for k in range(1, _T)]
        m_hat_inv = _mat_inv(m_hat)
        v_p = [sum(v[a] * m_hat_inv[a][b] for a in range(_T - 1)) % P
               for b in range(_T - 1)]
        sparse[i] = ([dense[0][0]] + v_p, w)
        mp = [[int(a == b == 0) for b in range(_T)] for a in range(_T)]
        for a in range(_T - 1):
            for b in range(_T - 1):
                mp[1 + a][1 + b] = m_hat[a][b]
        twist[i] = mp
        dense = _mat_mul(mp, m)
    p_mat = dense

    # Constants.  Entry rounds keep theirs; an exit round's pre-S-box
    # constant moves back through the previous round's M.  In the partial
    # rounds the deficit e_i of the optimized state against the twisted
    # naive state is solved backward (e at the exit is 0):
    #   u = M''_i^-1 @ (e_{i+1} + W_{i+1} @ c_{i+1}),  gamma_i = u[0],
    #   e_i = (0, u[1:]),  with W_i = M'_i and W_{R_P} = I;
    # the transition absorbs what is left: T = P^-1 @ (e_0 + W_0 @ c_HALF).
    f_vecs = [list(cr[r]) for r in range(HALF)]
    m_inv = _mat_inv(m)
    e_vecs = [_mat_vec(m_inv, cr[HALF + PARTIAL_ROUNDS + 1 + j])
              for j in range(HALF - 1)]
    gammas = [0] * PARTIAL_ROUNDS
    e = [0] * _T
    for i in range(PARTIAL_ROUNDS - 1, -1, -1):
        c_next = list(cr[HALF + i + 1])
        if i + 1 < PARTIAL_ROUNDS:
            c_next = _mat_vec(twist[i + 1], c_next)
        u = _mat_vec(_mat_inv(_sparse_to_dense(*sparse[i])),
                     [(e[k] + c_next[k]) % P for k in range(_T)])
        gammas[i] = u[0]
        e = [0] + u[1:]
    w0c = _mat_vec(twist[0], cr[HALF])
    t_vec = _mat_vec(_mat_inv(p_mat), [(e[k] + w0c[k]) % P for k in range(_T)])
    return f_vecs, t_vec, gammas, e_vecs, p_mat, sparse, m


@functools.lru_cache(maxsize=None)
def round_tables():
    """The schedule as the kernels walk it, plain field values:
    pre[r][e], post[r][e]  constants added before / after the S-box of full
                           round r = 0..FULL_ROUNDS-1 (0 where none);
    mix[r]                 full round r's matrix (P for r = HALF - 1, else M);
    gamma[i], row0[i][e], col0[i][k]  partial round i's scalar and sparse mix.
    """
    f_vecs, t_vec, gammas, e_vecs, p_mat, sparse, m = opt_tables()
    zero = [0] * _T
    pre = f_vecs + [zero] * HALF
    post = [zero] * (HALF - 1) + [t_vec] + e_vecs + [zero]
    mix = [m] * (HALF - 1) + [p_mat] + [m] * HALF
    return {"pre": pre, "post": post, "mix": mix, "gamma": list(gammas),
            "row0": [list(r) for r, _ in sparse],
            "col0": [list(c) for _, c in sparse]}
