"""The PyTorch port's GF(p) and GF(p^2) lane math against the JAX package's
ops (bit for bit, non-canonical inputs included) and against refimpl/field.py.

Integer results: the tolerance is 0.
"""

import numpy as np
import pytest
import torch

from halo2_plonky2_verifier_tpu.ops import goldilocks as jgl
from halo2_plonky2_verifier_tpu.ops import goldilocks_ext as jgle
from halo2_plonky2_verifier_tpu.refimpl import field as ref
from halo2_plonky2_verifier_tpu_torch.ops import goldilocks as tgl
from halo2_plonky2_verifier_tpu_torch.ops import goldilocks_ext as tgle

P = ref.P
EDGES = [0, 1, 2, P - 2, P - 1, P, P + 1, (1 << 64) - 1, (1 << 63), (1 << 32),
         (1 << 32) - 1]


def _values(seed, n=64, canonical=False):
    """Seeded u64 values: random below p, random below 2^64 and the edges."""
    rng = np.random.default_rng(seed)
    v = np.concatenate([
        rng.integers(0, P, size=n, dtype=np.uint64),
        rng.integers(0, 1 << 64, size=n // 2, dtype=np.uint64),
        np.array(EDGES, dtype=np.uint64)])
    if canonical:
        v = v[v < np.uint64(P)]
    return v


def _pair(seed, canonical=False):
    a = _values(seed, canonical=canonical)
    b = np.roll(_values(seed + 1000, canonical=canonical), 3)[:a.size]
    a = a[:b.size]
    return a, b


def _j(x):
    return jgl.from_u64(x)


def _t(x):
    return tgl.from_u64(x)


def _same(torch_out, jax_out):
    np.testing.assert_array_equal(tgl.to_u64(torch_out), jgl.to_u64(jax_out))


BINARY = {
    "add": (tgl.add, jgl.add),
    "sub": (tgl.sub, jgl.sub),
    "mul": (tgl.mul, jgl.mul),
}


@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_vs_jax(op):
    a, b = _pair(1)
    t_fn, j_fn = BINARY[op]
    _same(t_fn(_t(a), _t(b)), j_fn(_j(a), _j(b)))


UNARY = {
    "neg": (tgl.neg, jgl.neg),
    "square": (tgl.square, jgl.square),
    "canonicalize": (tgl.canonicalize, jgl.canonicalize),
    "inv": (tgl.inv, jgl.inv),
}


@pytest.mark.parametrize("op", sorted(UNARY))
def test_unary_vs_jax(op):
    a = _values(2)
    t_fn, j_fn = UNARY[op]
    _same(t_fn(_t(a)), j_fn(_j(a)))


@pytest.mark.parametrize("c", [0, 1, 7, 41, 0xFFFF])
def test_mul_const_small_vs_jax(c):
    a = _values(3)
    _same(tgl.mul_const_small(_t(a), c), jgl.mul_const_small(_j(a), c))


@pytest.mark.parametrize("e", [0, 1, 2, 7, 12345, P - 2])
def test_exp_const_vs_jax(e):
    a = _values(4)
    _same(tgl.exp_const(_t(a), e), jgl.exp_const(_j(a), e))


@pytest.mark.parametrize("bits", [1, 16, 31, 32, 33, 48, 63, 64])
def test_lt_pow2_vs_jax(bits):
    a = np.concatenate([_values(5), np.array(
        [(1 << min(bits, 63)) - 1, 1 << min(bits, 63)], dtype=np.uint64)])
    np.testing.assert_array_equal(tgl.lt_pow2(_t(a), bits).numpy(),
                                  np.asarray(jgl.lt_pow2(_j(a), bits)))


def test_predicates_vs_jax():
    a, b = _pair(6)
    b[::3] = a[::3]
    cond = np.arange(a.size) % 2 == 0
    np.testing.assert_array_equal(tgl.is_canonical(_t(a)).numpy(),
                                  np.asarray(jgl.is_canonical(_j(a))))
    np.testing.assert_array_equal(tgl.eq(_t(a), _t(b)).numpy(),
                                  np.asarray(jgl.eq(_j(a), _j(b))))
    _same(tgl.select(torch.from_numpy(cond), _t(a), _t(b)),
          jgl.select(cond, _j(a), _j(b)))


def test_base_ops_vs_refimpl():
    a, b = _pair(7, canonical=True)
    ta, tb = _t(a), _t(b)
    for t_out, fn in ((tgl.add(ta, tb), ref.add), (tgl.sub(ta, tb), ref.sub),
                      (tgl.mul(ta, tb), ref.mul)):
        assert [int(x) for x in tgl.to_u64(t_out)] == \
            [fn(int(x), int(y)) for x, y in zip(a, b)]
    nz = a[a != 0]
    assert [int(x) for x in tgl.to_u64(tgl.inv(_t(nz)))] == \
        [ref.inv(int(x)) for x in nz]


# ----------------------------------------------------------------------------
# GF(p^2)
# ----------------------------------------------------------------------------

def _ext(seed, canonical=False):
    a0, a1 = _pair(seed, canonical)
    return a0, a1


def _te(e):
    return (_t(e[0]), _t(e[1]))


def _je(e):
    return (_j(e[0]), _j(e[1]))


def _same_ext(t_out, j_out):
    _same(t_out[0], j_out[0])
    _same(t_out[1], j_out[1])


EXT_BINARY = {
    "add": (tgle.add, jgle.add),
    "sub": (tgle.sub, jgle.sub),
    "mul": (tgle.mul, jgle.mul),
}


@pytest.mark.parametrize("op", sorted(EXT_BINARY))
def test_ext_binary_vs_jax(op):
    a, b = _ext(10), _ext(20)
    t_fn, j_fn = EXT_BINARY[op]
    _same_ext(t_fn(_te(a), _te(b)), j_fn(_je(a), _je(b)))


EXT_UNARY = {
    "square": (tgle.square, jgle.square),
    "inv": (tgle.inv, jgle.inv),
    "neg": (tgle.neg, jgle.neg),
    "exp_const_5": (lambda x: tgle.exp_const(x, 5),
                    lambda x: jgle.exp_const(x, 5)),
    "exp_const_0": (lambda x: tgle.exp_const(x, 0),
                    lambda x: jgle.exp_const(x, 0)),
    "exp_power_of_2_5": (lambda x: tgle.exp_power_of_2(x, 5),
                         lambda x: jgle.exp_power_of_2(x, 5)),
}


@pytest.mark.parametrize("op", sorted(EXT_UNARY))
def test_ext_unary_vs_jax(op):
    a = _ext(30)
    t_fn, j_fn = EXT_UNARY[op]
    _same_ext(t_fn(_te(a)), j_fn(_je(a)))


def test_ext_scalar_mul_inv_pair_eq_vs_jax():
    a, b, s = _ext(40), _ext(50), _values(60)[:_ext(40)[0].size]
    _same_ext(tgle.scalar_mul(_te(a), _t(s)), jgle.scalar_mul(_je(a), _j(s)))
    t_inv = tgle.inv_pair(_te(a), _te(b))
    j_inv = jgle.inv_pair(_je(a), _je(b))
    _same_ext(t_inv[0], j_inv[0])
    _same_ext(t_inv[1], j_inv[1])
    b = (b[0].copy(), b[1].copy())
    b[0][::2], b[1][::2] = a[0][::2], a[1][::2]
    np.testing.assert_array_equal(tgle.eq(_te(a), _te(b)).numpy(),
                                  np.asarray(jgle.eq(_je(a), _je(b))))


@pytest.mark.parametrize("n_terms", [0, 3, 5])
def test_ext_reduce_with_powers_vs_jax(n_terms):
    terms = [_ext(70 + i) for i in range(n_terms)]
    alpha = _ext(99)
    _same_ext(tgle.reduce_with_powers([_te(t) for t in terms], _te(alpha)),
              jgle.reduce_with_powers([_je(t) for t in terms], _je(alpha)))


def test_ext_ops_vs_refimpl():
    a, b = _ext(80, canonical=True), _ext(90, canonical=True)
    n = min(a[0].size, b[0].size)
    a = (a[0][:n], a[1][:n])
    b = (b[0][:n], b[1][:n])

    def ints(e):
        return list(zip((int(x) for x in tgl.to_u64(e[0])),
                        (int(x) for x in tgl.to_u64(e[1]))))

    ra = list(zip(map(int, a[0]), map(int, a[1])))
    rb = list(zip(map(int, b[0]), map(int, b[1])))
    assert ints(tgle.mul(_te(a), _te(b))) == \
        [ref.ext_mul(x, y) for x, y in zip(ra, rb)]
    nz = [i for i, x in enumerate(ra) if x != (0, 0)]
    a_nz = (a[0][nz], a[1][nz])
    assert ints(tgle.inv(_te(a_nz))) == [ref.ext_inv(ra[i]) for i in nz]
    assert ints(tgle.reduce_with_powers([_te(a), _te(b)], _te(a))) == \
        [ref.reduce_with_powers_ext([x, y], x) for x, y in zip(ra, rb)]
