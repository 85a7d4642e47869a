"""GF(p^2) = GF(p)[X]/(X^2 - 7) on PyTorch int64 lanes.

An extension element is a pair `(a0, a1)` of int64 tensors (see
`ops/goldilocks.py`); the functions follow
`halo2_plonky2_verifier_tpu/ops/goldilocks_ext.py`.
"""

import torch

from . import goldilocks as gl

W = 7


def from_base(a):
    return (a, torch.zeros_like(a))


def zeros_like(a):
    return (torch.zeros_like(a[0]), torch.zeros_like(a[0]))


def add(a, b):
    return (gl.add(a[0], b[0]), gl.add(a[1], b[1]))


def sub(a, b):
    return (gl.sub(a[0], b[0]), gl.sub(a[1], b[1]))


def neg(a):
    return (gl.neg(a[0]), gl.neg(a[1]))


def mul(a, b):
    # (a0 + a1 X)(b0 + b1 X) = a0 b0 + 7 a1 b1 + (a0 b1 + a1 b0) X
    a0b0 = gl.mul(a[0], b[0])
    a1b1 = gl.mul(a[1], b[1])
    c0 = gl.add(a0b0, gl.mul_const_small(a1b1, W))
    c1 = gl.add(gl.mul(a[0], b[1]), gl.mul(a[1], b[0]))
    return (c0, c1)


def square(a):
    a0a0 = gl.square(a[0])
    a1a1 = gl.square(a[1])
    c0 = gl.add(a0a0, gl.mul_const_small(a1a1, W))
    a0a1 = gl.mul(a[0], a[1])
    return (c0, gl.add(a0a1, a0a1))


def scalar_mul(a, s):
    """Multiply by a base-field element s."""
    return (gl.mul(a[0], s), gl.mul(a[1], s))


def inv(a):
    """1/(a0 + a1 X) = (a0 - a1 X) / (a0^2 - 7 a1^2)."""
    norm = gl.sub(gl.square(a[0]), gl.mul_const_small(gl.square(a[1]), W))
    ninv = gl.inv(norm)
    return (gl.mul(a[0], ninv), gl.mul(gl.neg(a[1]), ninv))


def inv_pair(a, b):
    """(1/a, 1/b) with one base-field Fermat exponentiation (Montgomery's
    trick over the two norms)."""
    norm_a = gl.sub(gl.square(a[0]), gl.mul_const_small(gl.square(a[1]), W))
    norm_b = gl.sub(gl.square(b[0]), gl.mul_const_small(gl.square(b[1]), W))
    prod_inv = gl.inv(gl.mul(norm_a, norm_b))
    na_inv = gl.mul(prod_inv, norm_b)
    nb_inv = gl.mul(prod_inv, norm_a)
    return ((gl.mul(a[0], na_inv), gl.mul(gl.neg(a[1]), na_inv)),
            (gl.mul(b[0], nb_inv), gl.mul(gl.neg(b[1]), nb_inv)))


def exp_const(a, e):
    """a^e for a host-known exponent (square-and-multiply)."""
    e = int(e)
    if e == 0:
        return (gl.full(a[0].shape, 1, a[0].device), torch.zeros_like(a[0]))
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    return result


def exp_power_of_2(a, power_log):
    for _ in range(power_log):
        a = square(a)
    return a


def eq(a, b):
    return gl.eq(a[0], b[0]) & gl.eq(a[1], b[1])


def reduce_with_powers(terms, alpha):
    """Horner: sum_i terms[i] * alpha^i."""
    if not terms:
        return zeros_like(alpha)
    acc = zeros_like(terms[0])
    for t in reversed(terms):
        acc = add(mul(acc, alpha), t)
    return acc
