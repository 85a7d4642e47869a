// K3: the leaf sponge hash_n_to_m_no_pad, one thread per leaf.
//
// Replaces halo2_plonky2_verifier_tpu/ops/merkle_pallas.py:hash_no_pad_planes
// (kernel body _sponge_kernel).  Plain version and wrapper:
// ops/merkle_kernels.py:hash_no_pad_planes_plain / hash_no_pad_planes.
//
// Overwrite-mode absorb at rate 8: each chunk of up to 8 input rows replaces
// the front of the state, then one permutation; the hash is state[0:4].
//
// Bound: the ceil(w/8) permutations per lane (integer multiply-adds); the
// input is read once, w * 8 B per lane, coalesced because lanes are the
// fastest axis of the (w, N) planes.  The state stays in registers.

#include <cuda_runtime.h>

#include "poseidon_gl.cuh"

__global__ void leaf_sponge_kernel(const uint64_t* __restrict__ in,
                                   uint64_t* __restrict__ out, int w,
                                   int64_t n) {
  const int64_t lane = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint64_t st[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) st[k] = 0;
  for (int off = 0; off < w; off += 8) {
    const int k_end = min(8, w - off);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k < k_end) st[k] = in[(int64_t)(off + k) * n + lane];
    }
    gl::poseidon_gl_permute(st);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k * n + lane] = st[k];
}

extern "C" int launch_leaf_sponge(const void* in, void* out, int w,
                                  long long n, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    leaf_sponge_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, w, (int64_t)n);
  }
  return (int)cudaGetLastError();
}
