"""BN254 scalar field Fr in plain PyTorch.

Counterpart of `halo2_plonky2_verifier_tpu/ops/bn254.py` (and of the value
semantics of `ops/bn254_planes.py`).  At every API boundary an Fr element is
a (..., 4) int64 tensor holding its four little-endian u64 words (the same
container as a Goldilocks hash, so cap gathers, equality and stacking are
shared with the Goldilocks backend).  A CUDA kernel reads the same memory as
`uint64_t[4]`.

PyTorch on the CPU has no uint64 `>>`, `<` or `+`, so the arithmetic unpacks
each element into sixteen 16-bit limbs held in int64 (..., 16): a limb
product is < 2^32 and a column of sixteen of them < 2^36, so sums never
overflow.  `_normalize` propagates carries exactly over a whole tensor at
once (a few masked shift-adds, then one prefix pass for the remaining 0/1
ripple), so no Python loop runs over the limbs.

Montgomery convention as in the JAX package: R = 2^256, values inside a
permutation are x*R mod p, witness values stay in standard form.  Every
function returns canonical values (< p).  `mont_mul` needs a*b < R*p, which
holds when one factor is canonical and the other is any 256-bit value.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import profiling
from . import goldilocks as gl

P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
N_LIMBS = 16
R = 1 << 256
R2 = R * R % P
NPRIME = (-pow(P, -1, R)) % R       # -p^-1 mod 2^256
_M16 = 0xFFFF
_M56 = (1 << 56) - 1


# ----------------------------------------------------------------------------
# Host conversions
# ----------------------------------------------------------------------------

def int_to_words(v):
    """Host int in [0, 2^256) -> four int64 words (u64 bit patterns)."""
    return [gl.signed((int(v) >> (64 * k)) & ((1 << 64) - 1)) for k in range(4)]


def from_ints(vals, device="cpu"):
    """Nested host ints -> (..., 4) int64 words."""
    def conv(x):
        return [conv(y) for y in x] if isinstance(x, (list, tuple)) \
            else int_to_words(x)
    return torch.tensor(conv(vals), dtype=torch.int64, device=device)


def to_ints(a):
    """(..., 4) int64 words -> nested lists of host ints."""
    u = gl.to_u64(a)
    out = np.empty(u.shape[:-1], dtype=object).reshape(-1)
    for i, row in enumerate(u.reshape(-1, 4)):
        out[i] = sum(int(w) << (64 * k) for k, w in enumerate(row))
    return out.reshape(u.shape[:-1]).tolist()


@functools.lru_cache(maxsize=None)
def _limb_const(value, device):
    """(16,) int64 limbs of a host constant on `device`."""
    return torch.tensor([(value >> (16 * k)) & _M16 for k in range(N_LIMBS)],
                        dtype=torch.int64, device=device)


def to_limbs(words):
    """(..., 4) int64 words -> (..., 16) int64 16-bit limbs."""
    shifts = torch.tensor([0, 16, 32, 48], dtype=torch.int64,
                          device=words.device)
    limbs = (words[..., :, None] >> shifts) & _M16
    return limbs.reshape(words.shape[:-1] + (N_LIMBS,))


def from_limbs(limbs):
    """(..., 16) normalized limbs -> (..., 4) int64 words."""
    q = limbs.reshape(limbs.shape[:-1] + (4, 4))
    return q[..., 0] | (q[..., 1] << 16) | (q[..., 2] << 32) | (q[..., 3] << 48)


# ----------------------------------------------------------------------------
# Limb arithmetic (limb axis last)
# ----------------------------------------------------------------------------

def _normalize(cols):
    """Exact carry propagation of non-negative columns < 2^48 along the last
    axis -> limbs in [0, 2^16); a carry out of the top column is dropped.

    Four shift-add passes leave every column <= 2^16.  What remains is a 0/1
    ripple: a column of 2^16 generates a carry, a column of 0xFFFF passes one
    on.  The carry into column i is therefore the generate bit of the last
    column j < i that does not pass one on (cummax over their indices)."""
    cols = cols.clone()
    for _ in range(4):
        c = cols >> 16
        cols &= _M16
        cols[..., 1:] += c[..., :-1]
    k = cols.shape[-1]
    pos = torch.arange(k, dtype=torch.int64, device=cols.device)
    last = torch.where(cols == _M16, -1, pos).cummax(dim=-1).values
    gen = (cols >> 16).gather(-1, last.clamp(min=0)) & (last >= 0).long()
    cols[..., 1:] += gen[..., :-1]
    return cols & _M16


@functools.lru_cache(maxsize=None)
def _skew(device):
    """(256, 32) float64 0/1 matrix: partial product (i, j) -> column i+j."""
    s = torch.zeros((N_LIMBS * N_LIMBS, 2 * N_LIMBS), dtype=torch.float64)
    for i in range(N_LIMBS):
        for j in range(N_LIMBS):
            s[i * N_LIMBS + j, i + j] = 1.0
    return s.to(device)


@functools.lru_cache(maxsize=None)
def _toeplitz(consts, device):
    """Product by host constants as one (16 E, 32 F) float64 matrix: entry
    (e * 16 + i, f * 32 + i + k) is limb k of consts[f][e], so that limbs
    (..., E * 16) @ it gives, for each f, the raw columns of
    sum_e consts[f][e] * x_e.  `consts` is a tuple of F tuples of E ints."""
    n_f, n_e = len(consts), len(consts[0])
    t = torch.zeros((n_e * N_LIMBS, n_f * 2 * N_LIMBS), dtype=torch.float64)
    for f in range(n_f):
        for e in range(n_e):
            v = consts[f][e]
            for k in range(N_LIMBS):
                limb = (v >> (16 * k)) & _M16
                for i in range(N_LIMBS):
                    t[e * N_LIMBS + i, f * 2 * N_LIMBS + i + k] = limb
    return t.to(device)


def _cols(a, b):
    """Schoolbook product columns of two (..., 16) limb tensors (leading
    axes broadcast) -> (..., 32) raw columns, each < 2^36.  The partial
    products and their column sums are exact in float64 (< 2^53), so one
    matrix product by a 0/1 matrix adds every anti-diagonal."""
    prod = a.double()[..., :, None] * b.double()[..., None, :]
    lead = prod.shape[:-2]
    return (prod.reshape(lead + (N_LIMBS * N_LIMBS,))
            @ _skew(a.device)).long()


def _cols_const(x, consts):
    """Raw columns of sum_e consts[f][e] * x[..., e, :] for host constants:
    x (..., E, 16) limbs -> (..., F, 32), exact in float64 while E * 16
    products of 16-bit limbs stay below 2^53."""
    lead = x.shape[:-2]
    n_e = x.shape[-2]
    t = _toeplitz(consts, x.device)
    out = x.double().reshape(lead + (n_e * N_LIMBS,)) @ t
    return out.reshape(lead + (len(consts), 2 * N_LIMBS)).long()


def _cond_sub_p(x):
    """x - p where x >= p, for normalized limbs of x < 2p."""
    s = _normalize(F.pad(x + _limb_const(R - P, x.device), (0, 1)))
    return torch.where(s[..., N_LIMBS:] == 1, s[..., :N_LIMBS], x)


def _redc(t):
    """Montgomery reduction of normalized (..., 32) limbs t < R*p ->
    canonical t / R mod p."""
    m = _normalize(_cols_const(t[..., None, :N_LIMBS],
                               ((NPRIME,),))[..., 0, :N_LIMBS])   # mod R
    s = _normalize(t + _cols_const(m[..., None, :], ((P,),))[..., 0, :])
    return _cond_sub_p(s[..., N_LIMBS:])                      # < 2p -> < p


def _mont_mul_limbs(a, b):
    return _redc(_normalize(_cols(a, b)))


def mont_mul_limbs(a, b):
    """a * b / R mod p on (..., 16) limbs (leading axes broadcast)."""
    if profiling._ACTIVE is not None:
        profiling.record("bn254_mont_mul", profiling.lanes(a, b) // N_LIMBS)
    return _mont_mul_limbs(a, b)


def mont_matvec_limbs(consts, x):
    """y_f = sum_e consts[f][e] * x_e / R mod p for host constants
    (Montgomery form) and x (..., E, 16) canonical limbs -> (..., F, 16),
    with one reduction per output: the raw columns of a row's products are
    added first (a Poseidon MDS row is four products; 4p^2 < R*p keeps one
    REDC exact)."""
    return _redc(_normalize(_cols_const(x, consts)))


def add_mod_limbs(a, b):
    """(a + b) mod p on canonical (..., 16) limbs."""
    return _cond_sub_p(_normalize(a + b))


# ----------------------------------------------------------------------------
# Field ops on (..., 4) words
# ----------------------------------------------------------------------------

def mont_mul(a, b):
    """a * b * R^-1 mod p (canonical), for a * b < R * p."""
    if profiling._ACTIVE is not None:
        profiling.record("bn254_mont_mul", profiling.lanes(a, b) // 4)
    return from_limbs(_mont_mul_limbs(to_limbs(a), to_limbs(b)))


def to_mont_limbs(x):
    """x * R mod p on (..., 16) limbs of any 256-bit x (x * R2 < R * p)."""
    return _redc(_normalize(_cols_const(x[..., None, :], ((R2,),))[..., 0, :]))


def to_mont(a):
    """a * R mod p for any 256-bit a."""
    return from_limbs(to_mont_limbs(to_limbs(a)))


def from_mont(a):
    """a / R mod p: the standard form of a Montgomery value."""
    return from_limbs(_redc(F.pad(to_limbs(a), (0, N_LIMBS))))


def add_mod(a, b):
    """(a + b) mod p for canonical a, b."""
    return from_limbs(add_mod_limbs(to_limbs(a), to_limbs(b)))


def is_canonical(a):
    """a < p, on (..., 4) words -> (...,) bool."""
    s = _normalize(F.pad(to_limbs(a) + _limb_const(R - P, a.device), (0, 1)))
    return s[..., N_LIMBS] == 0


# ----------------------------------------------------------------------------
# Goldilocks interop (hashing conventions, reference: hash.rs:30-43, 101-114)
# ----------------------------------------------------------------------------

def pack_goldilocks(gl_words):
    """(..., k) int64 Goldilocks words, 1 <= k <= 3 -> standard-form Fr
    words: value = sum_k gl_k * 2^(64 k) < 2^192 < p, so word k is gl_k."""
    k = gl_words.shape[-1]
    if not 1 <= k <= 3:
        raise ValueError(f"pack_goldilocks takes 1 to 3 elements, got {k}")
    return F.pad(gl_words, (0, 4 - k))


def to_goldilocks_56(a):
    """Standard-form Fr words (..., 4) -> (..., 5) int64: the 56-bit
    little-endian limbs of decompose_le(x, 56, 5), each < 2^56 < p_gl."""
    w = [a[..., k] for k in range(4)]
    sh = gl._shr
    limbs = [w[0] & _M56,
             (sh(w[0], 56) | (w[1] << 8)) & _M56,
             (sh(w[1], 48) | (w[2] << 16)) & _M56,
             (sh(w[2], 40) | (w[3] << 24)) & _M56,
             sh(w[3], 32)]
    return torch.stack(limbs, dim=-1)
