"""Component probes of the BN254 permutation body and of the card's
multipliers: kernel K9 beside its plain PyTorch version.

Counterpart of `tools/bn254_micro.py:probe`, whose Pallas kernel runs CHAIN
dependent iterations of one of the TPU kernel's own functions.  K9,
`run_probe` (csrc/bn254_micro.cu), takes the probe as a launch argument: each
thread runs `chain` dependent iterations of one function of the K4-K6 body
(`csrc/poseidon_bn254.cuh`) on its own lane, so the time per iteration and
lane is that function's cost on the card (`tools/torch_bn254_micro.py`
reports it).  Where the TPU probe clamps u16 limbs to keep its chains alive,
every probe here computes a defined function of canonical Montgomery
values, so its plain version, built from `ops/bn254.py` and
`ops/poseidon_bn254.py`, reproduces it exactly.  The wrapper runs the plain
version for a CPU tensor and the kernel for a CUDA tensor, counts its
launches in `run_probe.launches` and keeps the last launch's (threads,
blocks) in `run_probe.last_launch`.

A probe's state is (rows, N) int64, lanes last; an Fr element is four rows
(row 4 * e + k = word k of element e), canonical Montgomery form:

  probe                    rows  one iteration i          plain version
  sqr_redc                   4   x <- x * x / R           fr.mont_mul(x, x)
  mont_mul                   8   x <- x * c / R; c (rows  fr.mont_mul
                                 4-7) is kept
  redc                       4   x <- x / R               fr.from_mont
  sbox                       4   x <- x^5                 pb.sbox5_limbs
  full_round                16   s <- full round i % 8    pb.full_round_opt_limbs
  partial_round_sparse      16   s <- partial round       pb.partial_round_opt_limbs
                                 i % 56
  partial_round_sparse_x2   32   the same on two states   the same
                                 a lane (thread)
  permute                   16   s <- the permutation     pb.permute_mont
  permute_group4            16   the same, a state over   pb.permute_mont
                                 four lanes of a warp
  u32_mul16                  1   16 times: x = (x * (x ^ j)) & 0xFFFF | 1
                                 on u32
  f32_mul16                  1   16 times: x = fmod(x * (x + j + 1), 65536)
                                 + 1 on f32, the product rounded to nearest
  wide_mul16                 1   16 times: x = hi32(x) * WIDE_C[j] + x
                                 mod 2^64

j = 0..15.  The rounds are the optimized schedule's
(`constants/poseidon_bn254_opt.py`): full rounds 0..3 then partial rounds
0..55 then full rounds 4..7 make one permutation.  The u32 and f32 probes
start from the low 16 bits of the input word and write their value back as
a word (u32: below 2^16; f32: an integer in [1, 65536]); the wide probe
starts from the whole word.

Launch forms: `threads` 0 sizes the launch to the card (every probe);
`permute` also runs at a fixed 128, 256 or 512 threads a block.  `k`, lanes
a thread, is 1 for the Fr probes and 1, 4 or 8 for the multiplier probes
(their chains interleaved in one thread).
"""

import ctypes

import torch

from ..constants.poseidon_bn254 import FULL_ROUNDS, PARTIAL_ROUNDS
from . import _build
from . import bn254 as fr
from . import poseidon_bn254 as pb
from .merkle_kernels import _check, _device
from .poseidon_kernels import _chain, _stream

# probe name -> (id in csrc/bn254_micro.cu, rows per lane)
PROBES = {
    "sqr_redc": (0, 4), "mont_mul": (1, 8), "redc": (2, 4), "sbox": (3, 4),
    "full_round": (4, 16), "partial_round_sparse": (5, 16),
    "partial_round_sparse_x2": (6, 32), "permute": (7, 16),
    "permute_group4": (8, 16), "u32_mul16": (9, 1), "f32_mul16": (10, 1),
    "wide_mul16": (11, 1),
}
MULTIPLIERS = ("u32_mul16", "f32_mul16", "wide_mul16")
THREADS = {"permute": (0, 128, 256, 512)}   # every other probe: (0,)
LANES_PER_THREAD = {m: (1, 4, 8) for m in MULTIPLIERS}  # the rest: (1,)
WIDE_C = tuple(0x1E3779B9 + 2 * j for j in range(16))   # csrc: wide_c
_M32 = (1 << 32) - 1


def _words(planes, elems):
    """(elems * 4, N) planes -> (N, elems, 4) words."""
    return planes.T.reshape(-1, elems, 4)


def _planes(words):
    """(N, elems, 4) words -> contiguous (elems * 4, N) planes."""
    return words.reshape(words.shape[0], -1).T.contiguous()


def _limb_state(fn):
    """A step on (..., 4) words from one on (..., 16) limbs."""
    return lambda s, i: fr.from_limbs(fn(fr.to_limbs(s), i))


def _partial_round(limbs, i):
    return pb.partial_round_opt_limbs(limbs, i % PARTIAL_ROUNDS)


# probe -> step(words (N, elems, 4), iteration) -> words
FR_STEPS = {
    "sqr_redc": lambda s, i: fr.mont_mul(s, s),
    "mont_mul": lambda s, i: torch.stack(
        [fr.mont_mul(s[:, 0], s[:, 1]), s[:, 1]], dim=1),
    "redc": lambda s, i: fr.from_mont(s),
    "sbox": _limb_state(lambda limbs, i: pb.sbox5_limbs(limbs)),
    "full_round": _limb_state(
        lambda limbs, i: pb.full_round_opt_limbs(limbs, i % FULL_ROUNDS)),
    "partial_round_sparse": _limb_state(_partial_round),
    "partial_round_sparse_x2": lambda s, i: _limb_state(_partial_round)(
        s.reshape(-1, 2, 4, 4), i).reshape(s.shape),
    "permute": lambda s, i: pb.permute_mont(s),
    "permute_group4": lambda s, i: pb.permute_mont(s),
}


def run_probe_plain(name, state, chain):
    """Plain K9: `chain` iterations of probe `name` on its (rows, N) int64
    state (see the module's table) -> the new (rows, N) state."""
    rows = PROBES[name][1]
    if name == "u32_mul16":
        x = state & 0xFFFF
        for _ in range(chain):
            for j in range(16):
                x = ((x * (x ^ j)) & 0xFFFF) | 1
        return x.contiguous()
    if name == "f32_mul16":
        x = (state & 0xFFFF).to(torch.float32)
        for _ in range(chain):
            for j in range(16):
                x = torch.fmod(x * (x + (j + 1)), 65536.0) + 1.0
        return x.to(torch.int64)
    if name == "wide_mul16":
        x = state.clone()
        for _ in range(chain):
            for c in WIDE_C:    # int64 wraps mod 2^64, as the u64 does
                x = ((x >> 32) & _M32) * c + x
        return x
    s = _words(state, rows // 4)
    step = FR_STEPS[name]
    for i in range(chain):
        s = step(s, i)
    return _planes(s)


def run_probe(name, state, chain, threads=0, k=1):
    """K9 wrapper: see `run_probe_plain` for the contract; `threads` (0:
    sized to the card) and `k` (lanes a thread) choose the kernel's launch
    form (`THREADS`, `LANES_PER_THREAD`), which the plain version ignores."""
    if name not in PROBES:
        raise ValueError(f"unknown probe {name!r}; known: {sorted(PROBES)}")
    allowed = THREADS.get(name, (0,))
    if threads not in allowed:
        raise ValueError(f"probe {name}: threads {threads} not in {allowed}")
    allowed = LANES_PER_THREAD.get(name, (1,))
    if k not in allowed:
        raise ValueError(f"probe {name}: k {k} not in {allowed}")
    probe, rows = PROBES[name]
    chain = _chain(chain)
    n = state.shape[-1]
    _check(state, "state", (rows, n), torch.int64)
    if _device(state).type == "cpu":
        return run_probe_plain(name, state, chain)
    fn = _build.kernel("bn254_micro")
    out = torch.empty_like(state)
    shape = (ctypes.c_longlong * 2)()
    status = fn(state.data_ptr(), out.data_ptr(), probe, chain, n, threads,
                k, shape, _stream(state))
    _build.check("bn254_micro", status)
    run_probe.launches += 1
    run_probe.last_launch = (shape[0], shape[1])
    return out


run_probe.launches = 0
run_probe.last_launch = None
