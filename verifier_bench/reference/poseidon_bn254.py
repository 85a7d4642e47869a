"""Poseidon over BN254 Fr and plonky2x's PoseidonBN128Hash conventions, as
plain Python ints: a frozen copy of the pure-int reference's module.

A hash is ONE Fr element.  Up to 3 Goldilocks elements pack into one Fr,
base 2^64 (`hash_or_noop`'s noop); the sponge absorbs chunks of 9
Goldilocks elements, each triple packed into state[1..3], and outputs
state[0]; `two_to_one` permutes [0, 0, left, right]; the transcript observes
an Fr as five 56-bit limbs.  The permutation is the circomlib t = 4
instance in its naive round structure.

`Hasher` memoises its results by their inputs: the benchmark's lanes repeat
a few distinct proofs, and a tampered lane shares all but one path with the
proof it was made from.
"""

from .constants import FULL_ROUNDS, P_BN254 as P, PARTIAL_ROUNDS, RATE, WIDTH
from .constants import generate

GL_BITS = 64
_ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS


def permute(state):
    c, m = generate()
    s0, s1, s2, s3 = (x % P for x in state)
    half = FULL_ROUNDS // 2
    (m00, m01, m02, m03), (m10, m11, m12, m13), (m20, m21, m22, m23), \
        (m30, m31, m32, m33) = m
    for r in range(_ROUNDS):
        k = 4 * r
        s0 = (s0 + c[k]) % P
        s1 = (s1 + c[k + 1]) % P
        s2 = (s2 + c[k + 2]) % P
        s3 = (s3 + c[k + 3]) % P
        s0 = pow(s0, 5, P)
        if r < half or r >= _ROUNDS - half:
            s1 = pow(s1, 5, P)
            s2 = pow(s2, 5, P)
            s3 = pow(s3, 5, P)
        s0, s1, s2, s3 = ((m00 * s0 + m01 * s1 + m02 * s2 + m03 * s3) % P,
                          (m10 * s0 + m11 * s1 + m12 * s2 + m13 * s3) % P,
                          (m20 * s0 + m21 * s1 + m22 * s2 + m23 * s3) % P,
                          (m30 * s0 + m31 * s1 + m32 * s2 + m33 * s3) % P)
    return [s0, s1, s2, s3]


def pack_goldilocks(elements):
    """<= 3 Goldilocks values -> one Fr, little-endian base 2^64."""
    acc = 0
    for x in reversed(elements):
        acc = (acc << GL_BITS) | int(x)
    return acc % P


def hash_no_pad(inputs):
    state = [0] * WIDTH
    for i in range(0, len(inputs), RATE * 3):
        chunk = inputs[i:i + RATE * 3]
        for j in range(0, len(chunk), 3):
            state[j // 3 + 1] = pack_goldilocks(chunk[j:j + 3])
        state = permute(state)
    return state[0]


def hash_or_noop(inputs):
    if len(inputs) <= 3:
        return pack_goldilocks(inputs)
    return hash_no_pad(inputs)


def two_to_one(left, right):
    return permute([0, 0, left % P, right % P])[0]


def to_goldilocks_vec(value):
    """Fr -> 5 x 56-bit limbs, little-endian."""
    v = int(value)
    return [(v >> (56 * k)) & ((1 << 56) - 1) for k in range(5)]


class Hasher:
    """`hash_or_noop` and `two_to_one`, memoised by their inputs."""

    def __init__(self):
        self._leaves = {}
        self._nodes = {}

    def leaf(self, elements):
        key = tuple(elements)
        h = self._leaves.get(key)
        if h is None:
            h = self._leaves[key] = hash_or_noop(list(key))
        return h

    def node(self, left, right):
        h = self._nodes.get((left, right))
        if h is None:
            h = self._nodes[(left, right)] = two_to_one(left, right)
        return h
