// K6: the standalone Poseidon-BN254 permutation, one thread per state.
//
// Replaces halo2_plonky2_verifier_tpu/ops/poseidon_bn254_pallas.py:
// permute_mont_planes (kernel body _permute_kernel), which the JAX package's
// BN254 transcript reaches once per sponge step through
// ops/poseidon_bn254.py:permute_mont -> permute_mont_batchlast.  Plain
// version and wrapper: ops/bn254_kernels.py:permute_planes_plain /
// permute_planes.
//
// Layout: (16, N) u64 planes, row 4 * e + k = word k of state element e,
// canonical Montgomery form in and out; lanes are the fastest axis, so a
// warp's loads and stores of one row are coalesced.
//
// Bound: the integer multiplies of one permutation per lane.  On the
// verifier's path N is the batch (1024 or 4096 proofs) and a transcript step
// is one launch, so the launch is short and fills the card poorly; 32-thread
// blocks spread the batch over as many SMs as it has warps.

#include <cuda_runtime.h>

#include "poseidon_bn254.cuh"

__global__ void bn254_permute_kernel(const uint64_t* __restrict__ in,
                                     uint64_t* __restrict__ out, int64_t n) {
  const int64_t lane = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint64_t s[4][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int k = 0; k < 4; ++k) s[e][k] = in[(e * 4 + k) * n + lane];
  }
  bn::poseidon_bn254_permute(s);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int k = 0; k < 4; ++k) out[(e * 4 + k) * n + lane] = s[e][k];
  }
}

extern "C" int launch_bn254_permute(const void* in, void* out, long long n,
                                    void* stream) {
  if (n > 0) {
    const int threads = 32;
    const long long blocks = (n + threads - 1) / threads;
    bn254_permute_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, (int64_t)n);
  }
  return (int)cudaGetLastError();
}
