"""Goldilocks GF(p), p = 2^64 - 2^32 + 1, and GF(p^2) = GF(p)[X]/(X^2 - 7),
as plain Python ints: a frozen copy of the pure-int reference's field
(plonky2's `GoldilocksField` and `QuadraticExtension`).  Extension elements
are tuples (a0, a1) meaning a0 + a1 X.
"""

P = (1 << 64) - (1 << 32) + 1
# Multiplicative group generator; also the coset shift used for LDEs
# (plonky2 GoldilocksField::MULTIPLICATIVE_GROUP_GENERATOR == coset_shift() == 7).
GENERATOR = 7
TWO_ADICITY = 32
# plonky2 GoldilocksField::POWER_OF_TWO_GENERATOR = 0x185629dcda58878c
# == 7^((p-1)/2^32) mod p (verified in tests).
POWER_OF_TWO_GENERATOR = 0x185629DCDA58878C
# Extension defining constant: X^2 = W (plonky2 <GoldilocksField as Extendable<2>>::W).
W = 7

# ----------------------------------------------------------------------------
# Base field
# ----------------------------------------------------------------------------

def add(a, b):
    return (a + b) % P


def sub(a, b):
    return (a - b) % P


def mul(a, b):
    return a * b % P


def neg(a):
    return -a % P


def inv(a):
    if a % P == 0:
        raise ZeroDivisionError("inverse of zero in GF(p)")
    return pow(a, P - 2, P)


def div(a, b):
    return a * inv(b) % P


def exp(a, e):
    return pow(a, e, P)


def exp_power_of_2(a, power_log):
    for _ in range(power_log):
        a = a * a % P
    return a


def primitive_root_of_unity(n_log):
    """plonky2 Field::primitive_root_of_unity: g_2adic^(2^(TWO_ADICITY - n_log))."""
    assert 0 <= n_log <= TWO_ADICITY
    return pow(POWER_OF_TWO_GENERATOR, 1 << (TWO_ADICITY - n_log), P)


def two_adic_subgroup(n_log):
    """[g^0, g^1, ..., g^(2^n_log - 1)] for g = primitive_root_of_unity(n_log).

    (reference: verifier/src/fri/mod.rs:240 GoldilocksField::two_adic_subgroup)
    """
    g = primitive_root_of_unity(n_log)
    out = [1]
    for _ in range((1 << n_log) - 1):
        out.append(out[-1] * g % P)
    return out


def batch_inv(xs):
    """Montgomery batch inversion; zero entries are not allowed."""
    n = len(xs)
    if n == 0:
        return []
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % P
    total_inv = inv(prefix[n])
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * total_inv % P
        total_inv = total_inv * xs[i] % P
    return out


# ----------------------------------------------------------------------------
# Quadratic extension GF(p^2) = GF(p)[X]/(X^2 - 7)
# ----------------------------------------------------------------------------

EXT_ZERO = (0, 0)
EXT_ONE = (1, 0)


def ext(a0, a1=0):
    return (a0 % P, a1 % P)


def ext_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def ext_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def ext_neg(a):
    return (-a[0] % P, -a[1] % P)


def ext_mul(a, b):
    # (a0 + a1 X)(b0 + b1 X) = a0 b0 + W a1 b1 + (a0 b1 + a1 b0) X
    # (reference: verifier/src/field/goldilocks/extension.rs:184-234)
    return (
        (a[0] * b[0] + W * a[1] * b[1]) % P,
        (a[0] * b[1] + a[1] * b[0]) % P,
    )


def ext_scalar_mul(a, s):
    return (a[0] * s % P, a[1] * s % P)


def ext_inv(a):
    # 1/(a0 + a1 X) = (a0 - a1 X) / (a0^2 - W a1^2)
    norm = (a[0] * a[0] - W * a[1] * a[1]) % P
    ninv = inv(norm)
    return (a[0] * ninv % P, -a[1] * ninv % P)


def ext_div(a, b):
    return ext_mul(a, ext_inv(b))


def ext_exp(a, e):
    result = EXT_ONE
    base = a
    while e:
        if e & 1:
            result = ext_mul(result, base)
        base = ext_mul(base, base)
        e >>= 1
    return result


def ext_exp_power_of_2(a, power_log):
    for _ in range(power_log):
        a = ext_mul(a, a)
    return a


def ext_from_base(a):
    return (a % P, 0)


def reduce_with_powers_ext(terms, alpha):
    """Horner: sum_i terms[i] * alpha^i, terms/alpha in GF(p^2).

    (reference: verifier/src/field/goldilocks/extension.rs:425-437)
    """
    acc = EXT_ZERO
    for t in reversed(terms):
        acc = ext_add(ext_mul(acc, alpha), t)
    return acc


def reduce_with_powers(terms, alpha):
    """Horner over the base field: sum_i terms[i] * alpha^i."""
    acc = 0
    for t in reversed(terms):
        acc = (acc * alpha + t) % P
    return acc
