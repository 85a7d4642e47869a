// K1: every Merkle path of a verification, one thread per path.
//
// Replaces halo2_plonky2_verifier_tpu/ops/merkle_pallas.py:verify_paths_planes
// (kernel body _path_kernel).  Plain version and wrapper:
// ops/merkle_kernels.py:verify_paths_planes_plain / verify_paths_planes.
//
// Per lane and per level l < d_max: the index bit picks whether the node is
// the right child, the state [left || right || 0] is permuted, and the first
// four outputs become the node where active[l] is set; the index shifts on
// every level, as the Pallas kernel does.  A level that is not active leaves
// the node unchanged, so the kernel skips its permutation: same output, and
// the slots of a shallower tree cost nothing past their depth.
//
// Bound: integer multiply-adds of the 30-round permutation (up to d_max of
// them per lane); the memory traffic is 32 B of sibling per level per lane.
// Lanes are the fastest axis of every array, so a warp's loads of one sibling
// element are coalesced, and the node stays in registers across all levels.
// The permutation is the one-thread K0 (poseidon_gl.cuh), whose rate follows
// the warps an SM holds; the launch bounds (threads a block, minimum blocks
// an SM, which caps the registers) and the unrolling of the partial rounds
// are the fastest setting without spills of tools/torch_gl_tune.py's sweep.

#include <cuda_runtime.h>

#include "poseidon_gl.cuh"

constexpr int PATH_THREADS = 512;
constexpr int PATH_PARTIAL_UNROLL = 22;

__global__ void __launch_bounds__(PATH_THREADS, 1)
    merkle_path_kernel(const uint64_t* __restrict__ node,
                       const uint64_t* __restrict__ sib,
                       const int64_t* __restrict__ idx,
                       const int32_t* __restrict__ active,
                       uint64_t* __restrict__ out, int64_t n, int d_max) {
  const int64_t lane = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint64_t h[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = node[k * n + lane];
  uint64_t ix = (uint64_t)idx[lane];
  for (int l = 0; l < d_max; ++l) {
    if (active[l * n + lane]) {
      const bool right = ix & 1;  // the node is the right child
      uint64_t st[12];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint64_t s = sib[(l * 4 + k) * n + lane];
        st[k] = right ? s : h[k];
        st[4 + k] = right ? h[k] : s;
        st[8 + k] = 0;
      }
      gl::poseidon_gl_permute<PATH_PARTIAL_UNROLL>(st);
#pragma unroll
      for (int k = 0; k < 4; ++k) h[k] = st[k];
    }
    ix >>= 1;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k * n + lane] = h[k];
}

extern "C" int launch_merkle_path(const void* node, const void* sib,
                                  const void* idx, const void* active,
                                  void* out, long long n, int d_max,
                                  void* stream) {
  if (n > 0) {
    const long long blocks = (n + PATH_THREADS - 1) / PATH_THREADS;
    merkle_path_kernel<<<(unsigned)blocks, PATH_THREADS, 0,
                         (cudaStream_t)stream>>>(
        (const uint64_t*)node, (const uint64_t*)sib, (const int64_t*)idx,
        (const int32_t*)active, (uint64_t*)out, (int64_t)n, d_max);
  }
  return (int)cudaGetLastError();
}
