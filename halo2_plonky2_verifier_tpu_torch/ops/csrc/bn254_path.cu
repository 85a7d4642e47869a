// K4: every BN254 Merkle path of a verification, one thread per path.
//
// Replaces halo2_plonky2_verifier_tpu/ops/poseidon_bn254_pallas.py:
// verify_paths_mont_planes (kernel body _path_kernel) with node_in_mont=True,
// the only form the verifier calls.  Plain version and wrapper:
// ops/bn254_kernels.py:verify_paths_mont_planes_plain /
// verify_paths_mont_planes.
//
// The node enters in canonical Montgomery form (K5's output) and stays so
// across levels.  Per level l where active[l] is set: the sibling (standard
// form, any 256-bit value, so also a tampered one >= p) is converted by one
// multiply by R^2 mod p (x * R2 < R * p, so the result is canonical), the
// index bit picks whether the node is the right child, the state
// [0, 0, left, right] is permuted, state[0] becomes the node, and the index
// shifts.  A level that is not active leaves node and index unchanged, so
// the kernel skips its permutation.  At exit the root leaves Montgomery form
// (canonical, standard form).
//
// Bound: the integer multiplies of up to d_max permutations per lane; the
// memory traffic is 32 B of sibling per level per lane, coalesced because
// lanes are the fastest axis.  The node stays in registers over all levels.

#include <cuda_runtime.h>

#include "poseidon_bn254.cuh"

__global__ void bn254_path_kernel(const uint64_t* __restrict__ node,
                                  const uint64_t* __restrict__ sib,
                                  const int64_t* __restrict__ idx,
                                  const int32_t* __restrict__ active,
                                  uint64_t* __restrict__ out, int64_t n,
                                  int d_max) {
  const int64_t lane = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint64_t h[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = node[k * n + lane];
  uint64_t ix = (uint64_t)idx[lane];
  for (int l = 0; l < d_max; ++l) {
    if (!active[l * n + lane]) continue;
    uint64_t sm[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) sm[k] = sib[(l * 4 + k) * n + lane];
    bn::to_mont(sm);
    const bool right = ix & 1;  // the node is the right child
    uint64_t s[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s[0][k] = 0;
      s[1][k] = 0;
      s[2][k] = right ? sm[k] : h[k];
      s[3][k] = right ? h[k] : sm[k];
    }
    bn::poseidon_bn254_permute(s);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = s[0][k];
    ix >>= 1;
  }
  bn::from_mont(h);
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k * n + lane] = h[k];
}

extern "C" int launch_bn254_path(const void* node, const void* sib,
                                 const void* idx, const void* active,
                                 void* out, long long n, int d_max,
                                 void* stream) {
  if (n > 0) {
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    bn254_path_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
        (const uint64_t*)node, (const uint64_t*)sib, (const int64_t*)idx,
        (const int32_t*)active, (uint64_t*)out, (int64_t)n, d_max);
  }
  return (int)cudaGetLastError();
}
