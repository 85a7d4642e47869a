"""The BN254 hot path: kernels K4 (Merkle paths), K5 (leaf hash_or_noop) and
K6 (the standalone permutation), each beside its plain PyTorch version.

Counterpart of `halo2_plonky2_verifier_tpu/ops/poseidon_bn254_pallas.py`.  A
wrapper runs the plain version for a CPU tensor and the CUDA kernel for a
CUDA tensor; there is no other switch.  Each wrapper counts its kernel
launches in its `launches` attribute.

K4, `verify_paths_mont_planes` (csrc/bn254_path.cu), replaces
`verify_paths_mont_planes` with node_in_mont=True.  K5,
`hash_or_noop_mont_planes` (csrc/bn254_leaf.cu), replaces
`hash_or_noop_mont_planes`.  K6, `permute_planes` (csrc/bn254_permute.cu),
replaces `permute_mont_planes`.  All three run the optimized schedule of
`csrc/poseidon_bn254.cuh` on 32-bit limbs; K4 and K5 keep one state per
thread (K5's sponge is the header's `leaf_hash`, launched at a shape chosen
by w), K6 spreads one over four lanes of a warp.  Values stay below 2p
inside a kernel and are made canonical before they are written, so the
kernels equal their plain versions (the naive schedule) bit for bit.

Layout: lanes last.  An Fr plane is (4, N) int64, row k = word k; a state
plane is (16, N), row 4 * e + k = word k of element e.
"""

import torch

from ..utils import profiling
from . import _build
from . import bn254 as fr
from . import poseidon_bn254 as pb
from .merkle_kernels import _check, _device


def _words(planes, rows):
    """(rows * 4, N) planes -> (N, rows, 4) words."""
    return planes.T.reshape(-1, rows, 4)


def _planes(words):
    """(N, rows, 4) words -> contiguous (rows * 4, N) planes."""
    return words.reshape(words.shape[0], -1).T.contiguous()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


# ----------------------------------------------------------------------------
# K6: the standalone permutation
# ----------------------------------------------------------------------------

@profiling.counted(profiling.bn254_planes)
def permute_planes_plain(state):
    """Plain K6: (16, N) canonical Montgomery state planes -> the permuted
    planes, canonical."""
    return _planes(pb.permute_mont(_words(state, 4)))


@profiling.counted(profiling.bn254_planes)
def permute_planes(state):
    """K6 wrapper: see `permute_planes_plain` for the contract."""
    n = state.shape[-1]
    _check(state, "state", (16, n), torch.int64)
    if _device(state).type == "cpu":
        return permute_planes_plain(state)
    fn = _build.kernel("bn254_permute")
    out = torch.empty_like(state)
    status = fn(state.data_ptr(), out.data_ptr(), n, _stream(state))
    _build.check("bn254_permute", status)
    permute_planes.launches += 1
    return out


permute_planes.launches = 0


# ----------------------------------------------------------------------------
# K5: leaf hash_or_noop
# ----------------------------------------------------------------------------

def _leaf_census(inputs):
    """No permutation for w <= 3 (packed), else ceil(w / 9) a leaf."""
    if inputs.dim() == 2 and inputs.shape[0] > 3:
        w, n = inputs.shape
        profiling.record_bn254_permutations(-(-w // 9) * n)


@profiling.counted(_leaf_census)
def hash_or_noop_mont_planes_plain(inputs):
    """Plain K5: (w, N) int64 Goldilocks words -> (4, N) canonical
    Montgomery Fr planes.  w <= 3 packs the elements into one Fr (no
    permutation); wider leaves go through the rate-9 sponge
    (`ops/poseidon_bn254.py:absorb_mont`), output state[0]."""
    gl_words = inputs.T
    if inputs.shape[0] <= 3:
        h = fr.to_mont(fr.pack_goldilocks(gl_words))
    else:
        h = pb.hash_no_pad_mont(gl_words)
    return h.T.contiguous()


@profiling.counted(_leaf_census)
def hash_or_noop_mont_planes(inputs):
    """K5 wrapper: see `hash_or_noop_mont_planes_plain` for the contract."""
    if inputs.dim() != 2 or inputs.shape[0] < 1:
        raise ValueError(f"inputs: expected (w, N) with w >= 1, got "
                         f"{tuple(inputs.shape)}")
    w, n = inputs.shape
    _check(inputs, "inputs", (w, n), torch.int64)
    if _device(inputs).type == "cpu":
        return hash_or_noop_mont_planes_plain(inputs)
    fn = _build.kernel("bn254_leaf")
    out = torch.empty((4, n), dtype=torch.int64, device=inputs.device)
    status = fn(inputs.data_ptr(), out.data_ptr(), w, n, _stream(inputs))
    _build.check("bn254_leaf", status)
    hash_or_noop_mont_planes.launches += 1
    return out


hash_or_noop_mont_planes.launches = 0


# ----------------------------------------------------------------------------
# K4: Merkle paths
# ----------------------------------------------------------------------------

def _paths_census(node, siblings, *_):
    """d_max x N two_to_one permutations, active or not, as the JAX census
    counts the padded level scan (`fri.py:merged_merkle_verdict` there)."""
    profiling.record_bn254_permutations(siblings.shape[0] * node.shape[-1])


@profiling.counted(_paths_census)
def verify_paths_mont_planes_plain(node, siblings, idx, active):
    """Plain K4.  node (4, N) canonical Montgomery leaf hashes (K5's
    output); siblings (d_max, 4, N) standard form, any 256-bit value; idx
    (N,) int64 leaf indices; active (d_max, N) int32 -> (4, N) standard-form
    roots.  Per active level: sibling to Montgomery form, the index bit
    selects the node's side, state [0, 0, left, right] is permuted and
    state[0] becomes the node; the index shifts only on active levels, as in
    the Pallas kernel."""
    h = node.T.clone()                                       # (N, 4)
    idx = idx.clone()
    for level in range(siblings.shape[0]):
        on = active[level].nonzero().squeeze(1)      # permute active lanes only
        hn, ix = h[on], idx[on]
        sm = fr.to_mont(siblings[level].T[on])
        right = (ix & 1).bool()[:, None]
        zero = torch.zeros_like(hn)
        state = torch.stack([zero, zero, torch.where(right, sm, hn),
                             torch.where(right, hn, sm)], dim=-2)
        h[on] = pb.permute_mont(state)[:, 0]
        idx[on] = ix >> 1
    return fr.from_mont(h).T.contiguous()


@profiling.counted(_paths_census)
def verify_paths_mont_planes(node, siblings, idx, active):
    """K4 wrapper: see `verify_paths_mont_planes_plain` for the contract."""
    n = node.shape[-1]
    d_max = siblings.shape[0] if siblings.dim() == 3 else -1
    _check(node, "node", (4, n), torch.int64)
    _check(siblings, "siblings", (d_max, 4, n), torch.int64)
    _check(idx, "idx", (n,), torch.int64)
    _check(active, "active", (d_max, n), torch.int32)
    if _device(node, siblings, idx, active).type == "cpu":
        return verify_paths_mont_planes_plain(node, siblings, idx, active)
    fn = _build.kernel("bn254_path")
    out = torch.empty_like(node)
    status = fn(node.data_ptr(), siblings.data_ptr(), idx.data_ptr(),
                active.data_ptr(), out.data_ptr(), n, d_max, _stream(node))
    _build.check("bn254_path", status)
    verify_paths_mont_planes.launches += 1
    return out


verify_paths_mont_planes.launches = 0
