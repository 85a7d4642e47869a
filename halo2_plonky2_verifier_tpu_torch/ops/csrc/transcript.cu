// K2: the whole Fiat-Shamir duplex sponge of each proof, one thread per proof.
//
// Replaces halo2_plonky2_verifier_tpu/ops/transcript_pallas.py:run_steps_planes
// (kernel body _transcript_kernel).  Plain version and wrapper:
// ops/transcript_kernels.py:run_steps_planes_plain / run_steps_planes.
//
// Per step s: the rate lanes j with mask[s][j] set are overwritten by the
// gathered observation chunk, the state is permuted, and state[0:8] is
// written out as the squeeze source of that step.
//
// Bound: latency.  The steps of one proof form a chain of dependent
// permutations, and a batch gives only B threads (1024 or 4096 on the
// verifier's path), far fewer than the card holds.  The design keeps the
// state in registers for the whole chain and uses 32-thread blocks, so the
// batch spreads over as many SMs as it has warps.

#include <cuda_runtime.h>

#include "poseidon_gl.cuh"

__global__ void transcript_kernel(const uint64_t* __restrict__ chunks,
                                  const int32_t* __restrict__ mask,
                                  uint64_t* __restrict__ ys, int n_steps,
                                  int64_t b) {
  const int64_t lane = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (lane >= b) return;
  uint64_t st[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) st[k] = 0;
  for (int s = 0; s < n_steps; ++s) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (mask[s * 8 + k]) st[k] = chunks[(int64_t)(s * 8 + k) * b + lane];
    }
    gl::poseidon_gl_permute(st);
#pragma unroll
    for (int k = 0; k < 8; ++k) ys[(int64_t)(s * 8 + k) * b + lane] = st[k];
  }
}

extern "C" int launch_transcript(const void* chunks, const void* mask,
                                 void* ys, int n_steps, long long b,
                                 void* stream) {
  if (b > 0) {
    const int threads = 32;
    const long long blocks = (b + threads - 1) / threads;
    transcript_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
        (const uint64_t*)chunks, (const int32_t*)mask, (uint64_t*)ys,
        n_steps, (int64_t)b);
  }
  return (int)cudaGetLastError();
}
