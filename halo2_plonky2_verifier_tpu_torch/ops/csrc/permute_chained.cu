// K8: `chain` Poseidon-Goldilocks permutations in a row on each state, the
// state held in registers throughout, one thread per state.
//
// Replaces halo2_plonky2_verifier_tpu/ops/poseidon_pallas.py:
// _permute_chained_call_impl (inner kernel, a fori_loop over the VMEM-
// resident state; public permute_planes_chained), the "chained" and "mid"
// speed-of-light probes of tools/sol_bench.py.  Plain version and wrapper:
// ops/poseidon_kernels.py:permute_planes_chained_plain /
// permute_planes_chained.
//
// Layout as K7: (12, N) u64 planes, lanes the fastest axis.  chain = 0
// copies the input (fori_loop(0, 0) returns its operand).
//
// Bound: the integer multiplies of `chain` permutations per lane; the memory
// traffic is one read and one write of the state for all of them, so at the
// probe's chain 64 the kernel measures the permutation's compute rate.
//
// Each thread runs a chain of `chain` permutations, so a partly filled last
// round of blocks idles SMs for a whole chain: the launch is sized to the
// card as K3's (sized_launch.cuh), at most 1024 threads a block and one
// block an SM (64 registers), in rounds of equal size.

#include <cuda_runtime.h>

#include "poseidon_gl.cuh"
#include "sized_launch.cuh"

constexpr int CHAINED_THREADS = 1024;
constexpr int CHAINED_MIN_BLOCKS = 1;
constexpr int CHAINED_PARTIAL_UNROLL = 1;

__global__ void __launch_bounds__(CHAINED_THREADS, CHAINED_MIN_BLOCKS)
    permute_chained_kernel(const uint64_t* __restrict__ in,
                           uint64_t* __restrict__ out, int64_t n,
                           int chain) {
  const int64_t lane = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint64_t s[12];
#pragma unroll
  for (int e = 0; e < 12; ++e) s[e] = in[e * n + lane];
#pragma unroll 1
  for (int c = 0; c < chain; ++c)
    gl::poseidon_gl_permute<CHAINED_PARTIAL_UNROLL>(s);
#pragma unroll
  for (int e = 0; e < 12; ++e) out[e * n + lane] = s[e];
}

static CardCache card;

extern "C" int launch_permute_chained(const void* in, void* out, long long n,
                                      int chain, void* stream) {
  if (chain < 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    int threads;
    long long blocks;
    const cudaError_t e = sized_launch<CHAINED_THREADS>(
        card, permute_chained_kernel, n, threads, blocks);
    if (e != cudaSuccess) {
      cudaGetLastError();   // clear it, so no later launch reports it
      return (int)e;
    }
    permute_chained_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, (int64_t)n, chain);
  }
  return (int)cudaGetLastError();
}
