"""The Fiat-Shamir transcript: kernel K2 beside its plain PyTorch version.

Counterpart of `halo2_plonky2_verifier_tpu/ops/transcript_pallas.py`.  K2,
`run_steps_planes` (csrc/transcript.cu), replaces
`transcript_pallas.py:run_steps_planes`.  The wrapper runs the plain version
for a CPU tensor and the kernel for a CUDA tensor, and counts its launches in
`run_steps_planes.launches`.

The sponge of one proof is a chain of dependent permutations, so the kernel
is bound by latency, not by throughput: one proof's state is spread over a
group of 16, 8 or 4 lanes (the largest that leaves each of the card's
schedulers at most one warp), held in registers for every step, and the only
memory traffic is the chunks in and the squeeze outputs out.
"""

import torch

from ..utils import profiling
from . import _build
from .merkle_kernels import _check, _device
from .poseidon import SPONGE_RATE, W, permute_planes_plain


def _steps_census(chunks, *_):
    """One permutation a step a proof."""
    if chunks.dim() == 3:
        profiling.record_gl_permutations(chunks.shape[0] * chunks.shape[-1])


@profiling.counted(_steps_census)
def run_steps_planes_plain(chunks, mask):
    """Plain K2.  chunks (n_steps, 8, B) int64 gathered observation chunks;
    mask (n_steps, 8) int32, 1 where the step overwrites the rate lane.
    Returns the squeeze outputs ys, (n_steps, 8, B): state[0:8] after each
    step's permutation, from an all-zero initial state."""
    n_steps, _, b = chunks.shape
    state = torch.zeros((W, b), dtype=torch.int64, device=chunks.device)
    ys = []
    for s in range(n_steps):
        pre = torch.where(mask[s].bool()[:, None], chunks[s],
                          state[:SPONGE_RATE])
        state = permute_planes_plain(torch.cat([pre, state[SPONGE_RATE:]]))
        ys.append(state[:SPONGE_RATE])
    return torch.stack(ys)


@profiling.counted(_steps_census)
def run_steps_planes(chunks, mask):
    """K2 wrapper: see `run_steps_planes_plain` for the contract."""
    if chunks.dim() != 3:
        raise ValueError(f"chunks: expected (n_steps, 8, B), got "
                         f"{tuple(chunks.shape)}")
    n_steps, _, b = chunks.shape
    _check(chunks, "chunks", (n_steps, SPONGE_RATE, b), torch.int64)
    _check(mask, "mask", (n_steps, SPONGE_RATE), torch.int32)
    if _device(chunks, mask).type == "cpu":
        return run_steps_planes_plain(chunks, mask)
    fn = _build.kernel("transcript")
    ys = torch.empty_like(chunks)
    status = fn(chunks.data_ptr(), mask.data_ptr(), ys.data_ptr(), n_steps, b,
                torch.cuda.current_stream(chunks.device).cuda_stream)
    _build.check("transcript", status)
    run_steps_planes.launches += 1
    return ys


run_steps_planes.launches = 0
