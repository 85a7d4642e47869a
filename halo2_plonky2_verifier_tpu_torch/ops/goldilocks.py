"""Goldilocks field GF(p), p = 2^64 - 2^32 + 1, on PyTorch int64 lanes.

One field element is one `torch.int64` element holding the u64 bit pattern
(the JAX package splits it into a (hi, lo) uint32 pair).  A CUDA kernel reads
the same memory as `uint64_t*`.

PyTorch has no uint64 add, `>>` or `<` on the CPU, so the u64 operations are
spelled on int64:

- add, sub and the low half of a product wrap mod 2^64 on int64 as on u64;
- `>>` is arithmetic, so `_shr` masks after the shift;
- `<` is signed, so `_ult` compares `x ^ INT64_MIN` for the unsigned order;
- a 64x64 -> 128-bit product is built from 32-bit limbs (`_mul128`).

Every function follows the JAX package's algorithm step for step
(`halo2_plonky2_verifier_tpu/ops/goldilocks.py`), so results agree bit for
bit also on non-canonical inputs (values in [p, 2^64)).
"""

import numpy as np
import torch

from ..utils import profiling

P = (1 << 64) - (1 << 32) + 1
EPSILON = (1 << 32) - 1          # 2^64 mod p
GENERATOR = 7                    # multiplicative generator and coset shift
TWO_ADICITY = 32
POWER_OF_TWO_GENERATOR = 0x185629DCDA58878C

_M32 = 0xFFFFFFFF
_MIN = -(1 << 63)


def signed(v):
    """Host int in [0, 2^64) -> the int64 value with the same bit pattern."""
    v = int(v) & ((1 << 64) - 1)
    return v - (1 << 64) if v >> 63 else v


_P_S = signed(P)


# ----------------------------------------------------------------------------
# Host-side conversions and constants
# ----------------------------------------------------------------------------

def from_u64(x, device="cpu"):
    """numpy uint64 array (or nested ints) -> int64 tensor, same bits."""
    x = np.ascontiguousarray(np.asarray(x, dtype=np.uint64))
    return torch.from_numpy(x.view(np.int64)).to(device)


def to_u64(a):
    """int64 tensor -> numpy uint64 array, same bits."""
    return a.detach().cpu().contiguous().numpy().view(np.uint64)


def full(shape, value, device="cpu"):
    return torch.full(shape, signed(int(value) % P), dtype=torch.int64,
                      device=device)


def zeros(shape, device="cpu"):
    return torch.zeros(shape, dtype=torch.int64, device=device)


def primitive_root_of_unity(n_log):
    """plonky2 Field::primitive_root_of_unity (host int)."""
    assert 0 <= n_log <= TWO_ADICITY
    return pow(POWER_OF_TWO_GENERATOR, 1 << (TWO_ADICITY - n_log), P)


def two_adic_subgroup(n_log):
    """[g^0, ..., g^(2^n_log - 1)] for g = primitive_root_of_unity(n_log)."""
    g = primitive_root_of_unity(n_log)
    out = [1]
    for _ in range((1 << n_log) - 1):
        out.append(out[-1] * g % P)
    return out


def batch_inv_host(xs):
    """Inverses of nonzero host ints."""
    return [pow(x, P - 2, P) for x in xs]


def reverse_index_bits(xs):
    """Permute xs so the element at index i moves to the bit-reversed index."""
    n = len(xs)
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    out = [None] * n
    for i, x in enumerate(xs):
        j = int(format(i, f"0{log_n}b")[::-1], 2) if log_n else 0
        out[j] = x
    return out


# ----------------------------------------------------------------------------
# u64 helpers on int64 tensors
# ----------------------------------------------------------------------------

def _shr(a, k):
    """Logical right shift of the u64 pattern by 0 < k < 64."""
    return (a >> k) & ((1 << (64 - k)) - 1)


def _ult(a, b):
    """Unsigned a < b on the u64 patterns (b may be a host int)."""
    if isinstance(b, int):
        return (a ^ _MIN) < (signed(b) ^ _MIN)
    return (a ^ _MIN) < (b ^ _MIN)


def _mul128(a, b):
    """Exact 128-bit product of two u64 patterns -> (hi, lo)."""
    al, ah = a & _M32, _shr(a, 32)
    bl, bh = b & _M32, _shr(b, 32)
    ll = al * bl                      # each < 2^64: exact as a u64 pattern
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    mid = _shr(ll, 32) + (lh & _M32) + (hl & _M32)        # < 3 * 2^32
    lo = (ll & _M32) | (mid << 32)
    hi = hh + _shr(lh, 32) + _shr(hl, 32) + _shr(mid, 32)  # < 2^64
    return hi, lo


def canonicalize(a):
    """Subtract p once if a >= p (a - p = a + EPSILON mod 2^64)."""
    return torch.where(_ult(a, P), a, a + EPSILON)


def reduce128(hi, lo):
    """(hi * 2^64 + lo) mod p, canonical; 2^96 = -1 and 2^64 = EPSILON."""
    hh = _shr(hi, 32)
    hlo = hi & _M32
    t0 = lo - hh
    t0 = torch.where(_ult(lo, hh), t0 - EPSILON, t0)
    t1 = (hlo << 32) - hlo
    s = t0 + t1
    s = torch.where(_ult(s, t0), s + EPSILON, s)
    return canonicalize(s)


# ----------------------------------------------------------------------------
# Field ops
# ----------------------------------------------------------------------------

def add(a, b):
    if profiling._ACTIVE is not None:
        profiling.record("gl_add", profiling.lanes(a, b))
    s = a + b
    # a carry means + 2^64 = + EPSILON (mod p)
    s = torch.where(_ult(s, a), s + EPSILON, s)
    return canonicalize(s)


def sub(a, b):
    d = a - b
    # a borrow means the result wrapped by 2^64; a - b + p = wrapped - EPSILON
    return torch.where(_ult(a, b), d - EPSILON, d)


def neg(a):
    return sub(torch.zeros_like(a), a)


def mul(a, b):
    if profiling._ACTIVE is not None:
        profiling.record("gl_mul", profiling.lanes(a, b))
    return reduce128(*_mul128(a, b))


def square(a):
    if profiling._ACTIVE is not None:
        profiling.record("gl_mul", profiling.lanes(a))
    return reduce128(*_mul128(a, a))


def mul_const_small(a, c):
    """a * c for a small host constant 0 <= c < 2^16."""
    assert 0 <= c < (1 << 16)
    if c == 0:
        return torch.zeros_like(a)
    if c == 1:
        return a
    p0 = (a & _M32) * c                        # < 2^48
    mid = _shr(p0, 32) + _shr(a, 32) * c       # < 2^49
    lo = (p0 & _M32) | (mid << 32)
    return reduce128(mid >> 32, lo)


def select(cond, a, b):
    return torch.where(cond, a, b)


def eq(a, b):
    return a == b


def is_canonical(a):
    """a < p: the witness range check."""
    return _ult(a, P)


def lt_pow2(a, bits):
    """a < 2^bits for 0 < bits <= 64 (the PoW response check)."""
    if bits >= 64:
        return torch.ones_like(a, dtype=torch.bool)
    return _ult(a, 1 << bits)


def exp_const(a, e):
    """a^e for a host-known exponent e >= 0 (square-and-multiply)."""
    e = int(e)
    if e == 0:
        return full(a.shape, 1, a.device)
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    return result


def exp_power_of_2(a, n):
    """a^(2^n): n squarings."""
    for _ in range(n):
        a = square(a)
    return a


def _exp_2k_minus_1(a, k, cache):
    """a^(2^k - 1) with a memoized doubling chain."""
    if k in cache:
        return cache[k]
    if k == 1:
        cache[1] = a
        return a
    half = k // 2
    rest = k - half
    lo = _exp_2k_minus_1(a, half, cache)
    acc = exp_power_of_2(lo, rest)
    hi = _exp_2k_minus_1(a, rest, cache)
    out = mul(acc, hi)
    cache[k] = out
    return out


def inv(a):
    """a^(p-2) by Fermat, p - 2 = (2^32 - 2) * 2^32 + (2^32 - 1).
    inv(0) = 0; callers guard or the verdict catches it."""
    cache = {}
    e31 = _exp_2k_minus_1(a, 31, cache)
    e32 = _exp_2k_minus_1(a, 32, cache)
    t = exp_power_of_2(square(e31), 32)
    return mul(t, e32)
