"""Poseidon over BN254 Fr and the plonky2x hashing conventions, plain
PyTorch.

Counterpart of `halo2_plonky2_verifier_tpu/ops/poseidon_bn254.py`: the
circomlib t=4 instance (x^5 S-box, 8 full + 56 partial rounds) in naive round
form, with the state in Montgomery form inside the permutation.  These
functions are the plain versions that the BN254 kernels K4, K5 and K6 are
held against (`ops/bn254_kernels.py`).

A state is (..., 4, 4) int64: four Fr elements of four u64 words each.  The
MDS mix adds the raw product columns of each row and reduces once per row
(4 p^2 < R p), which keeps the plain permutation affordable on the CPU.

`permute_mont_limbs_opt` computes the same permutation by the optimized
schedule (`constants/poseidon_bn254_opt.py`) that the kernels' body
(`csrc/poseidon_bn254.cuh`) runs, from the same tables: the CPU check of
that schedule and its constants.  The plain versions of the kernels call the
naive `permute_mont_limbs`, so the card's comparison does not rest on the
optimized schedule; only K9's round probes, which time one round of that
schedule, are held against its rounds (`full_round_opt_limbs`,
`partial_round_opt_limbs`).
"""

import functools

import torch

from ..constants import poseidon_bn254_opt as pbo
from ..constants.poseidon_bn254 import (FULL_ROUNDS, PARTIAL_ROUNDS, RATE,
                                        WIDTH, generate)
from ..utils import profiling
from . import bn254 as fr

ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS
HALF = FULL_ROUNDS // 2


def mont_tables():
    """Host tables: round constants (ROUNDS * WIDTH ints) and the MDS
    (WIDTH x WIDTH ints), both in Montgomery form."""
    c, m = generate()
    return ([v * fr.R % fr.P for v in c],
            [[v * fr.R % fr.P for v in row] for row in m])


@functools.lru_cache(maxsize=None)
def _round_constants(device):
    """(ROUNDS, 4, 16) Montgomery-form round constants as limbs."""
    c, _ = mont_tables()
    return fr.to_limbs(fr.from_ints(c, device)).reshape(ROUNDS, WIDTH,
                                                        fr.N_LIMBS)


@functools.lru_cache(maxsize=None)
def _mds():
    """The Montgomery-form MDS as a tuple of rows (a hashable constant)."""
    return tuple(tuple(row) for row in mont_tables()[1])


def sbox5_limbs(x):
    """x^5 on (..., 16) canonical Montgomery limbs."""
    x2 = fr.mont_mul_limbs(x, x)
    x4 = fr.mont_mul_limbs(x2, x2)
    return fr.mont_mul_limbs(x4, x)


def mix_mont_limbs(state):
    """The MDS mix new[i] = sum_j M[i][j] * state[j] on (..., 4, 16)
    canonical Montgomery limbs, one reduction per row."""
    return fr.mont_matvec_limbs(_mds(), state)


def round_mont_limbs(state, r):
    """Round r (constant layer, S-box, mix) on (..., 4, 16) canonical
    Montgomery limbs: every element's S-box in the first and last HALF
    rounds, element 0's in the partial rounds between."""
    state = fr.add_mod_limbs(state, _round_constants(state.device)[r])
    if r < HALF or r >= ROUNDS - HALF:
        state = sbox5_limbs(state)
    else:
        state = torch.cat([sbox5_limbs(state[..., :1, :]), state[..., 1:, :]],
                          dim=-2)
    return mix_mont_limbs(state)


def _limbs_census(state):
    """One permutation a (4, 16)-limb state of (..., 4, 16)."""
    profiling.record_bn254_permutations(state.numel() // (WIDTH * 16))


@profiling.counted(_limbs_census)
def permute_mont_limbs(state):
    """(..., 4, 16) canonical Montgomery limbs -> the permuted state."""
    for r in range(ROUNDS):
        state = round_mont_limbs(state, r)
    return state


@functools.lru_cache(maxsize=None)
def _opt_mont_tables():
    """`constants/poseidon_bn254_opt.py:round_tables` in Montgomery form, as
    tuples of host ints (hashable, so each matrix is a cached constant of
    `fr.mont_matvec_limbs`)."""
    def mont(v):
        return (tuple(mont(x) for x in v) if isinstance(v, (list, tuple))
                else v * fr.R % fr.P)
    return {k: mont(v) for k, v in pbo.round_tables().items()}


@functools.lru_cache(maxsize=None)
def _opt_limbs(key, device):
    """(n, ..., 16) limbs of table `key` of `_opt_mont_tables`."""
    return fr.to_limbs(fr.from_ints(_opt_mont_tables()[key], device))


def full_round_opt_limbs(state, r):
    """Full round r of the optimized schedule: constants before and after
    every element's S-box, then round r's dense mix."""
    t = _opt_mont_tables()
    state = fr.add_mod_limbs(state, _opt_limbs("pre", state.device)[r])
    state = sbox5_limbs(state)
    state = fr.add_mod_limbs(state, _opt_limbs("post", state.device)[r])
    return fr.mont_matvec_limbs(t["mix"][r], state)


def partial_round_opt_limbs(state, i):
    """Partial round i of the optimized schedule: S-box and scalar constant on element 0, then the sparse mix:
    new0 = row0 . s, new_k = s_k + col0[k-1] s0."""
    t = _opt_mont_tables()
    s0 = fr.add_mod_limbs(sbox5_limbs(state[..., :1, :]),
                          _opt_limbs("gamma", state.device)[i])
    new0 = fr.mont_matvec_limbs((t["row0"][i],),
                                torch.cat([s0, state[..., 1:, :]], dim=-2))
    rest = fr.add_mod_limbs(state[..., 1:, :], fr.mont_matvec_limbs(
        tuple((c,) for c in t["col0"][i]), s0))
    return torch.cat([new0, rest], dim=-2)


@profiling.counted(_limbs_census)
def permute_mont_limbs_opt(state):
    """(..., 4, 16) canonical Montgomery limbs -> the permuted state, by the
    optimized schedule: HALF full rounds, PARTIAL_ROUNDS partial rounds,
    HALF full rounds.  Equal to `permute_mont_limbs`."""
    for r in range(HALF):
        state = full_round_opt_limbs(state, r)
    for i in range(PARTIAL_ROUNDS):
        state = partial_round_opt_limbs(state, i)
    for r in range(HALF, FULL_ROUNDS):
        state = full_round_opt_limbs(state, r)
    return state


def _words_census(state):
    """One permutation a (4, 4)-word state of (..., 4, 4)."""
    profiling.record_bn254_permutations(state.numel() // (WIDTH * 4))


@profiling.counted(_words_census)
def permute_mont(state):
    """(..., 4, 4) canonical Montgomery words -> the permuted state."""
    return fr.from_limbs(permute_mont_limbs(fr.to_limbs(state)))


def permute(state):
    """Standard-form (..., 4, 4) state -> standard-form permuted state."""
    return fr.from_mont(permute_mont(fr.to_mont(state)))


# ----------------------------------------------------------------------------
# plonky2x hashing conventions (reference: hash.rs, permutation.rs:205-252)
# ----------------------------------------------------------------------------

def absorb_mont(state, gl_words):
    """Absorb (..., k) Goldilocks words into a (..., 4, 4) Montgomery state:
    chunks of RATE * 3 = 9, each triple packed into one Fr overwriting slot
    1 + j (a partial last chunk overwrites only the ceil(len/3) slots it
    covers), one permutation per chunk."""
    k = gl_words.shape[-1]
    for i in range(0, k, RATE * 3):
        chunk = gl_words[..., i:i + RATE * 3]
        slots = [fr.to_mont(fr.pack_goldilocks(chunk[..., j:j + 3]))
                 for j in range(0, chunk.shape[-1], 3)]
        state = permute_mont(torch.cat(
            [state[..., :1, :], torch.stack(slots, dim=-2),
             state[..., 1 + len(slots):, :]], dim=-2))
    return state


def hash_no_pad_mont(gl_words):
    """Sponge over (..., k) Goldilocks words -> Montgomery Fr state[0]."""
    state = torch.zeros(gl_words.shape[:-1] + (WIDTH, 4), dtype=torch.int64,
                        device=gl_words.device)
    return absorb_mont(state, gl_words)[..., 0, :]


def hash_or_noop_gl(gl_words):
    """(..., k) Goldilocks words -> standard-form Fr (..., 4): packed for
    k <= 3, else the sponge."""
    if gl_words.shape[-1] <= 3:
        return fr.pack_goldilocks(gl_words)
    return fr.from_mont(hash_no_pad_mont(gl_words))


def two_to_one(left, right):
    """left, right: standard-form Fr (..., 4); zero state with slots 2, 3."""
    zero = torch.zeros_like(left)
    state = torch.stack([zero, zero, fr.to_mont(left), fr.to_mont(right)],
                        dim=-2)
    return fr.from_mont(permute_mont(state)[..., 0, :])
