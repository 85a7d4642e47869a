// K7: the standalone Poseidon-Goldilocks permutation, one thread per state.
//
// Replaces halo2_plonky2_verifier_tpu/ops/poseidon_pallas.py:_permute_kernel
// (called from _permute_planes_call_impl; public permute_planes and the
// batch-last permute), which the JAX package reaches for bulk hashing:
// batch-last absorb / hash_no_pad / two_to_one, the PLONK public-input hash
// and the "streamed" probe of tools/sol_bench.py.  Plain version and wrapper:
// ops/poseidon_kernels.py:permute_planes_plain / permute_planes.
//
// Layout: (12, N) u64 planes, row e = state element e; lanes are the fastest
// axis, so a warp's loads and stores of one row are coalesced.  Any u64 input
// is taken (the first constant layer reduces it, as the plain version does);
// the output is canonical.
//
// Bound: the integer multiplies of one permutation per lane (6,436 32-bit
// multiplies in its cheapest known form against 192 bytes moved), so the
// state stays in registers for all 30 rounds and each element is read and
// written once.  Lanes and offsets are 64-bit integers, so e * n + lane
// cannot overflow at any N (the probes use up to 12 x 2^21 words).
//
// The one-thread body (poseidon_gl.cuh) issues about 33,700 instructions a
// permutation against 6,436 multiplies in the bound, so the rate is that at
// which the SMs keep issuing, not the multiplier's.  128-thread blocks
// (68 registers) ran it at 6.4x the bound; this launch takes
// 1024-thread blocks, one an SM (the compiler holds 64 registers with a
// spill of a few bytes), with the partial rounds a loop, the fastest at
// both 2^17 and 2^21 states of tools/torch_gl_tune.py's sweep, as
// 512-thread blocks were for K1.  Two states a thread side by side (255
// registers, or 128 and a spill) and one state over four lanes (K2's group
// form, which repeats element 0's S-box in every lane) ran slower
// (PERF.md §6).

#include <cuda_runtime.h>

#include "poseidon_gl.cuh"

constexpr int PERMUTE_THREADS = 1024;
constexpr int PERMUTE_PARTIAL_UNROLL = 1;

__global__ void __launch_bounds__(PERMUTE_THREADS, 1)
    permute_kernel(const uint64_t* __restrict__ in,
                   uint64_t* __restrict__ out, int64_t n) {
  const int64_t lane = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint64_t s[12];
#pragma unroll
  for (int e = 0; e < 12; ++e) s[e] = in[e * n + lane];
  gl::poseidon_gl_permute<PERMUTE_PARTIAL_UNROLL>(s);
#pragma unroll
  for (int e = 0; e < 12; ++e) out[e * n + lane] = s[e];
}

extern "C" int launch_permute(const void* in, void* out, long long n,
                              void* stream) {
  if (n > 0) {
    const long long blocks = (n + PERMUTE_THREADS - 1) / PERMUTE_THREADS;
    permute_kernel<<<(unsigned)blocks, PERMUTE_THREADS, 0,
                     (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, (int64_t)n);
  }
  return (int)cudaGetLastError();
}
