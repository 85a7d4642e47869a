"""The standalone Goldilocks permutation: kernel K7 (one permutation per
state) and kernel K8 (`chain` permutations per state), each beside its plain
PyTorch version.

Counterpart of `halo2_plonky2_verifier_tpu/ops/poseidon_pallas.py`.  A
wrapper runs the plain version for a CPU tensor and the CUDA kernel for a
CUDA tensor; there is no other switch.  Each wrapper counts its kernel
launches in its `launches` attribute.

K7, `permute_planes` (csrc/permute.cu), replaces
`poseidon_pallas.py:permute_planes` (kernel `_permute_kernel`): the bulk
permutation behind the batch-last hashing API of `ops/poseidon.py`.  K8,
`permute_planes_chained` (csrc/permute_chained.cu), replaces
`poseidon_pallas.py:permute_planes_chained`, the speed-of-light probe of
`tools/torch_sol_bench.py`.  Both are bound by the permutation's integer
multiplies: one thread per state keeps the 12 elements in registers on the
shared K0 body (`csrc/poseidon_gl.cuh`), K7 in 1024-thread blocks, K8 in a
launch sized to the card's SMs (`csrc/sized_launch.cuh`).  The TPU
kernels' bf16 limb-plane MDS, POSEIDON_GROUPS regrouping and lane tiles are
not carried over.

Layout: (12, N) int64 planes, lanes last, any u64 values in; the output is
canonical.
"""

import operator

import torch

from ..utils import profiling
from . import _build
from .merkle_kernels import _check, _device
from .poseidon import W, permute_planes_plain


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _chain(chain):
    chain = operator.index(chain)
    if not 0 <= chain < 1 << 31:
        raise ValueError(f"chain must be in [0, 2^31), got {chain}")
    return chain


# ----------------------------------------------------------------------------
# K7: one permutation
# ----------------------------------------------------------------------------

@profiling.counted(profiling.gl_planes)
def permute_planes(state):
    """K7 wrapper: (12, N) int64 -> the permuted (12, N) state; see
    `ops/poseidon.py:permute_planes_plain` for the plain version."""
    n = state.shape[-1]
    _check(state, "state", (W, n), torch.int64)
    if _device(state).type == "cpu":
        return permute_planes_plain(state)
    fn = _build.kernel("permute")
    out = torch.empty_like(state)
    status = fn(state.data_ptr(), out.data_ptr(), n, _stream(state))
    _build.check("permute", status)
    permute_planes.launches += 1
    return out


permute_planes.launches = 0


# ----------------------------------------------------------------------------
# K8: `chain` permutations
# ----------------------------------------------------------------------------

def _chained_census(state, chain):
    profiling.record_gl_permutations(chain * state.shape[-1])


@profiling.counted(_chained_census)
def permute_planes_chained_plain(state, chain):
    """Plain K8: (12, N) int64 -> the state after `chain` permutations; chain
    0 returns a copy of the input, as `fori_loop(0, 0)` returns its
    operand."""
    state = state.clone()
    for _ in range(chain):
        state = permute_planes_plain(state)
    return state


@profiling.counted(_chained_census)
def permute_planes_chained(state, chain):
    """K8 wrapper: see `permute_planes_chained_plain` for the contract."""
    chain = _chain(chain)
    n = state.shape[-1]
    _check(state, "state", (W, n), torch.int64)
    if _device(state).type == "cpu":
        return permute_planes_chained_plain(state, chain)
    fn = _build.kernel("permute_chained")
    out = torch.empty_like(state)
    status = fn(state.data_ptr(), out.data_ptr(), n, chain, _stream(state))
    _build.check("permute_chained", status)
    permute_planes_chained.launches += 1
    return out


permute_planes_chained.launches = 0

__all__ = ["permute_planes", "permute_planes_plain",
           "permute_planes_chained", "permute_planes_chained_plain"]
