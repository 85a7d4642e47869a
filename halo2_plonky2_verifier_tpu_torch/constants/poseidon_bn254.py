"""Poseidon-over-BN254-Fr constants (circomlib/gnark/plonky2x-compatible),
for the PyTorch port.

A copy of `halo2_plonky2_verifier_tpu/constants/poseidon_bn254.py`: the JAX
package's `__init__` imports jax, so the port cannot import it from there.
`tests/test_torch_bn254.py` asserts that the copy generates the same tables.

The reference's PoseidonBN254 chips consume gnark's optimized constant tables
C/M/P/S via plonky2x (reference: verifier/src/hash/poseidon_bn254/
permutation.rs:7-11).  Those tables are an algebraic re-association of the
circomlib Poseidon instance (t = 4, x^5 S-box, 8 full + 56 partial rounds)
whose base constants are generated by the Poseidon authors' Grain LFSR and
whose MDS is the Grain-sampled Cauchy matrix.  We generate the base tables
here and execute the mathematically-equivalent naive permutation.

Validation (tests/test_poseidon_bn254.py):
  - the t=3 instance generated identically reproduces circomlib's canonical
    hash test vector poseidon([1, 2]);
  - the t=4 instance reproduces the go-iden3-crypto vector poseidon([1,2,3]).
Either anchor pins the generation end-to-end (a single wrong bit in the LFSR
stream scrambles the 254-bit outputs).
"""

import functools

# BN254 (a.k.a. BN128) scalar field modulus
P_BN254 = 21888242871839275222246405745257275088548364400416034343698204186575808495617

WIDTH = 4           # t
RATE = 3
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 56

# Canonical external test vectors (circomlib / go-iden3-crypto):
KAT_T3_HASH_1_2 = 7853200120776062878684798364095072458815029376092732009249414926327459813530
KAT_T4_HASH_1_2_3 = 6542985608222806190361240322586112750744169038454362455181422643027100751666


def _grain_gen(field, sbox, n, t, r_f, r_p):
    bits = []
    for val, width in [(field, 2), (sbox, 4), (n, 12), (t, 12), (r_f, 10), (r_p, 10)]:
        bits += [int(b) for b in bin(val)[2:].zfill(width)]
    bits += [1] * 30

    def new_bit():
        nb = bits[62] ^ bits[51] ^ bits[38] ^ bits[23] ^ bits[13] ^ bits[0]
        bits.pop(0)
        bits.append(nb)
        return nb

    for _ in range(160):
        new_bit()
    while True:
        nb = new_bit()
        while nb == 0:
            new_bit()
            nb = new_bit()
        yield new_bit()


def _random_bits(gen, k):
    v = 0
    for _ in range(k):
        v = (v << 1) | next(gen)
    return v


@functools.lru_cache(maxsize=None)
def generate(t=WIDTH, r_f=FULL_ROUNDS, r_p=PARTIAL_ROUNDS, n=254):
    """Returns (C, M): round constants (len (r_f+r_p)*t) and the t x t MDS."""
    gen = _grain_gen(1, 0, n, t, r_f, r_p)
    num = (r_f + r_p) * t
    c = []
    while len(c) < num:
        v = _random_bits(gen, n)
        if v < P_BN254:
            c.append(v)
    while True:
        xs = [_random_bits(gen, n) % P_BN254 for _ in range(t)]
        ys = [_random_bits(gen, n) % P_BN254 for _ in range(t)]
        if len(set(xs + ys)) == 2 * t:
            break
    m = [[pow((xs[i] + ys[j]) % P_BN254, P_BN254 - 2, P_BN254) for j in range(t)]
         for i in range(t)]
    return tuple(c), tuple(tuple(row) for row in m)
