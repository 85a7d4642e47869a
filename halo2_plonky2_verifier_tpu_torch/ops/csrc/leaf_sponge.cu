// K3: the leaf sponge hash_n_to_m_no_pad, one thread per leaf.
//
// Replaces halo2_plonky2_verifier_tpu/ops/merkle_pallas.py:hash_no_pad_planes
// (kernel body _sponge_kernel).  Plain version and wrapper:
// ops/merkle_kernels.py:hash_no_pad_planes_plain / hash_no_pad_planes.
//
// Overwrite-mode absorb at rate 8 (poseidon_gl.cuh:leaf_sponge): each chunk
// of up to 8 input rows replaces the front of the state, then one
// permutation; the hash is state[0:4].  Any w >= 0 and any n.
//
// Bound: the ceil(w/8) permutations per lane (integer multiply-adds); the
// input is read once, w * 8 B per lane, coalesced because lanes are the
// fastest axis of the (w, N) planes.  The state stays in registers.
//
// Each thread runs a chain of ceil(w/8) permutations, so a partly filled
// last round of blocks idles SMs for a whole chain: the launch is sized to
// the card (sized_launch.cuh), at most 1024 threads a block and one block
// an SM (64 registers), in rounds of equal size.  The grid covers n, so the
// lane loop runs once a thread; written as a loop, the kernel compiled to
// code 2-3% faster than with one lane a thread at both w=32 shapes of
// tools/torch_gl_tune.py (PERF.md §6), which K8 did not.

#include <cuda_runtime.h>

#include "poseidon_gl.cuh"
#include "sized_launch.cuh"

constexpr int SPONGE_THREADS = 1024;
constexpr int SPONGE_MIN_BLOCKS = 1;
constexpr int SPONGE_PARTIAL_UNROLL = 1;

__global__ void __launch_bounds__(SPONGE_THREADS, SPONGE_MIN_BLOCKS)
    leaf_sponge_kernel(const uint64_t* __restrict__ in,
                       uint64_t* __restrict__ out, int w, int64_t n) {
  for (int64_t lane = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       lane < n; lane += (int64_t)gridDim.x * blockDim.x) {
    uint64_t h[4];
    gl::leaf_sponge<SPONGE_PARTIAL_UNROLL>(in, n, lane, w, h);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k * n + lane] = h[k];
  }
}

static CardCache card;

extern "C" int launch_leaf_sponge(const void* in, void* out, int w,
                                  long long n, void* stream) {
  if (n > 0) {
    int threads;
    long long blocks;
    const cudaError_t e = sized_launch<SPONGE_THREADS>(
        card, leaf_sponge_kernel, n, threads, blocks);
    if (e != cudaSuccess) {
      cudaGetLastError();   // clear it, so no later launch reports it
      return (int)e;
    }
    leaf_sponge_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, w, (int64_t)n);
  }
  return (int)cudaGetLastError();
}
