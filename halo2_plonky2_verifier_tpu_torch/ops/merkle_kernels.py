"""The Merkle hot path: kernel K1 (every Merkle path of a verification) and
kernel K3 (the leaf sponge), each beside its plain PyTorch version.

Counterpart of `halo2_plonky2_verifier_tpu/ops/merkle_pallas.py`.  A wrapper
runs the plain version for a CPU tensor and the CUDA kernel for a CUDA
tensor; there is no other switch.  Each wrapper counts its kernel launches in
its `launches` attribute.

K1, `verify_paths_planes` (csrc/merkle_path.cu), replaces
`merkle_pallas.py:verify_paths_planes`.  It is bound by the permutations'
integer multiply-adds: one thread per path keeps the node in registers over
all levels and skips the permutation of a level that is not active.

K3, `hash_no_pad_planes` (csrc/leaf_sponge.cu), replaces
`merkle_pallas.py:hash_no_pad_planes`.  It is bound by its ceil(w/8)
permutations per leaf: one thread per leaf keeps the sponge state in
registers and reads each input row once, coalesced across lanes; the launch
is sized to the card's SMs (csrc/sized_launch.cuh), so that no round of
blocks leaves SMs idle for a whole chain of permutations.

Layout: lanes last, (rows, N) int64, as in the JAX package's plane form.
"""

import torch

from ..utils import profiling
from . import _build
from .poseidon import W, permute_planes_plain, two_to_one_planes_plain


def _check(t, name, shape, dtype):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device(*tensors):
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("all inputs must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# ----------------------------------------------------------------------------
# K1: Merkle paths
# ----------------------------------------------------------------------------

def _paths_census(node, siblings, *_):
    """Every level of every path, active or not: d_max x N two_to_one
    permutations, as the JAX census counts the padded level scan
    (`fri.py:merkle_scan_planes` there)."""
    profiling.record_gl_permutations(siblings.shape[0] * node.shape[-1])


@profiling.counted(_paths_census)
def verify_paths_planes_plain(node, siblings, idx, active):
    """Plain K1.  node (4, N), siblings (d_max, 4, N) int64; idx (N,) int64
    leaf indices; active (d_max, N) int32 (1 while the level is inside the
    path's tree) -> (4, N) root planes.  The index shifts on every level, as
    in the Pallas kernel; with active levels forming a prefix (the verifier
    pads depths at the end) that gives the root of the JAX scan, which shifts
    only on active levels."""
    for level in range(siblings.shape[0]):
        sib = siblings[level]
        right = (idx & 1).bool()                 # the node is the right child
        left_in = torch.where(right, sib, node)
        right_in = torch.where(right, node, sib)
        new = two_to_one_planes_plain(left_in, right_in)
        node = torch.where(active[level].bool(), new, node)
        idx = idx >> 1
    return node


@profiling.counted(_paths_census)
def verify_paths_planes(node, siblings, idx, active):
    """K1 wrapper: see `verify_paths_planes_plain` for the contract."""
    n = node.shape[-1]
    d_max = siblings.shape[0] if siblings.dim() == 3 else -1
    _check(node, "node", (4, n), torch.int64)
    _check(siblings, "siblings", (d_max, 4, n), torch.int64)
    _check(idx, "idx", (n,), torch.int64)
    _check(active, "active", (d_max, n), torch.int32)
    if _device(node, siblings, idx, active).type == "cpu":
        return verify_paths_planes_plain(node, siblings, idx, active)
    fn = _build.kernel("merkle_path")
    out = torch.empty_like(node)
    status = fn(node.data_ptr(), siblings.data_ptr(), idx.data_ptr(),
                active.data_ptr(), out.data_ptr(), n, d_max,
                torch.cuda.current_stream(node.device).cuda_stream)
    _build.check("merkle_path", status)
    verify_paths_planes.launches += 1
    return out


verify_paths_planes.launches = 0


# ----------------------------------------------------------------------------
# K3: leaf sponge
# ----------------------------------------------------------------------------

def _sponge_census(inputs):
    """ceil(w / 8) permutations a leaf of (w, N)."""
    if inputs.dim() == 2:
        w, n = inputs.shape
        profiling.record_gl_permutations(-(-w // 8) * n)


@profiling.counted(_sponge_census)
def hash_no_pad_planes_plain(inputs):
    """Plain K3: (w, N) int64 -> (4, N), plonky2 hash_n_to_m_no_pad with
    overwrite-mode rate-8 absorb."""
    w, n = inputs.shape
    state = torch.zeros((W, n), dtype=torch.int64, device=inputs.device)
    for off in range(0, w, 8):
        k = min(8, w - off)
        state = permute_planes_plain(
            torch.cat([inputs[off:off + k], state[k:]]))
    return state[:4]


@profiling.counted(_sponge_census)
def hash_no_pad_planes(inputs):
    """K3 wrapper: see `hash_no_pad_planes_plain` for the contract."""
    if inputs.dim() != 2:
        raise ValueError(f"inputs: expected (w, N), got {tuple(inputs.shape)}")
    w, n = inputs.shape
    _check(inputs, "inputs", (w, n), torch.int64)
    if _device(inputs).type == "cpu":
        return hash_no_pad_planes_plain(inputs)
    fn = _build.kernel("leaf_sponge")
    out = torch.empty((4, n), dtype=torch.int64, device=inputs.device)
    status = fn(inputs.data_ptr(), out.data_ptr(), w, n,
                torch.cuda.current_stream(inputs.device).cuda_stream)
    _build.check("leaf_sponge", status)
    hash_no_pad_planes.launches += 1
    return out


hash_no_pad_planes.launches = 0
