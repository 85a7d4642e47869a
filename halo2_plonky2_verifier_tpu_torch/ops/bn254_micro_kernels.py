"""Component probes of the BN254 permutation: kernel K9 beside its plain
PyTorch version.

Counterpart of `tools/bn254_micro.py:probe`, whose Pallas kernel runs CHAIN
dependent iterations of one part of the TPU permutation.  K9, `run_probe`
(csrc/bn254_micro.cu), takes the probe as a launch argument: each thread runs
`chain` dependent iterations of one part of the K4-K6 body
(`csrc/poseidon_bn254.cuh`) on its own lane, so the time per iteration and
lane is that part's cost on the card (`tools/torch_bn254_micro.py` reports
it).  Where the TPU probe clamps u16 limbs to keep its chains alive, every
probe here computes a defined function of canonical Montgomery values, so its
plain version, built from `ops/bn254.py` and `ops/poseidon_bn254.py`,
reproduces it exactly.  The wrapper runs the plain version for a CPU tensor
and the kernel for a CUDA tensor, and counts its launches in
`run_probe.launches`.

A probe's state is (rows, N) int64, lanes last; an Fr element is four rows
(row 4 * e + k = word k of element e), canonical Montgomery form:

  probe             rows  one iteration i
  sqr_redc            4   x <- x * x / R (the S-box's squaring stage)
  mont_mul            8   x <- x * c / R; c (rows 4-7) is kept
  redc                4   x <- x / R
  mix                16   s <- the dense 4 x 4 MDS mix, one REDC per row
  partial_round      16   s <- partial round HALF + i % PARTIAL_ROUNDS
  partial_round_x2   32   the same on two states per lane (thread)
  permute            16   s <- the whole permutation
  u32_mul16           1   16 times: x = (x * (x ^ j)) & 0xFFFF | 1 on u32
  f32_mul16           1   16 times: x = fmod(x * (x + j + 1), 65536) + 1
                          on f32, the product rounded to nearest

j = 0..15.  The two multiplier probes start from the low 16 bits of the
input word and write their value back as a word (u32: below 2^16; f32: an
integer in [1, 65536]).  `permute` runs at 128, 256 or 512 threads per
block; every other probe at 128.
"""

import torch

from . import _build
from . import bn254 as fr
from . import poseidon_bn254 as pb
from .merkle_kernels import _check, _device
from .poseidon_kernels import _chain, _stream

# probe name -> (id in csrc/bn254_micro.cu, rows per lane)
PROBES = {
    "sqr_redc": (0, 4), "mont_mul": (1, 8), "redc": (2, 4), "mix": (3, 16),
    "partial_round": (4, 16), "partial_round_x2": (5, 32),
    "permute": (6, 16), "u32_mul16": (7, 1), "f32_mul16": (8, 1),
}
THREADS = {"permute": (128, 256, 512)}      # every other probe: (128,)


def _words(planes, elems):
    """(elems * 4, N) planes -> (N, elems, 4) words."""
    return planes.T.reshape(-1, elems, 4)


def _planes(words):
    """(N, elems, 4) words -> contiguous (elems * 4, N) planes."""
    return words.reshape(words.shape[0], -1).T.contiguous()


def _limb_state(fn):
    """A step on (..., 4, 4) words from one on (..., 4, 16) limbs."""
    return lambda s, i: fr.from_limbs(fn(fr.to_limbs(s), i))


def _partial_round(limbs, i):
    return pb.round_mont_limbs(limbs, pb.HALF + i % pb.PARTIAL_ROUNDS)


_FR_STEPS = {   # probe -> step(words (N, elems, 4), iteration) -> words
    "sqr_redc": lambda s, i: fr.mont_mul(s, s),
    "mont_mul": lambda s, i: torch.stack(
        [fr.mont_mul(s[:, 0], s[:, 1]), s[:, 1]], dim=1),
    "redc": lambda s, i: fr.from_mont(s),
    "mix": _limb_state(lambda limbs, i: pb.mix_mont_limbs(limbs)),
    "partial_round": _limb_state(_partial_round),
    "partial_round_x2": lambda s, i: _limb_state(_partial_round)(
        s.reshape(-1, 2, 4, 4), i).reshape(s.shape),
    "permute": lambda s, i: pb.permute_mont(s),
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
    s = _words(state, rows // 4)
    step = _FR_STEPS[name]
    for i in range(chain):
        s = step(s, i)
    return _planes(s)


def run_probe(name, state, chain, threads=128):
    """K9 wrapper: see `run_probe_plain` for the contract; `threads` is the
    kernel's block size (`THREADS`), which the plain version ignores."""
    if name not in PROBES:
        raise ValueError(f"unknown probe {name!r}; known: {sorted(PROBES)}")
    allowed = THREADS.get(name, (128,))
    if threads not in allowed:
        raise ValueError(f"probe {name}: threads {threads} not in {allowed}")
    probe, rows = PROBES[name]
    chain = _chain(chain)
    n = state.shape[-1]
    _check(state, "state", (rows, n), torch.int64)
    if _device(state).type == "cpu":
        return run_probe_plain(name, state, chain)
    fn = _build.kernel("bn254_micro")
    out = torch.empty_like(state)
    status = fn(state.data_ptr(), out.data_ptr(), probe, chain, n, threads,
                _stream(state))
    _build.check("bn254_micro", status)
    run_probe.launches += 1
    return out


run_probe.launches = 0
