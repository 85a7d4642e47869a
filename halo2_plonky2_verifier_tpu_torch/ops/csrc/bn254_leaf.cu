// K5: the BN254 leaf hash_or_noop over w Goldilocks elements, one thread
// per leaf.
//
// Replaces halo2_plonky2_verifier_tpu/ops/poseidon_bn254_pallas.py:
// hash_or_noop_mont_planes (kernel body _leaf_kernel).  Plain version and
// wrapper: ops/bn254_kernels.py:hash_or_noop_mont_planes_plain /
// hash_or_noop_mont_planes.
//
// w <= 3: the elements pack into one Fr (word k = element k, value < 2^192),
// converted to Montgomery form, no permutation.  Otherwise the sponge:
// chunks of 9 elements, each triple packed into one Fr that overwrites state
// slot 1 + j (a partial last chunk overwrites only the ceil(len / 3) slots it
// covers; a missing element of a covered slot packs as zero), one
// permutation per chunk.  The output is state[0] (or the packed value), in
// canonical Montgomery form, which K4 takes as its node.
//
// Bound: the ceil(w / 9) permutations per lane (integer multiplies); the
// input is read once, w * 8 B per lane, coalesced because lanes are the
// fastest axis of the (w, N) planes.  w is a launch argument.  The body is
// poseidon_bn254.cuh's (values below 2p inside, canonical at exit), under
// the same register budget as K4.

#include <cuda_runtime.h>

#include "poseidon_bn254.cuh"

constexpr int LEAF_THREADS = 128;

// x <- to_mont(pack(in rows lo .. hi-1)) for one lane (below 2p).
__device__ __forceinline__ void pack_to_mont(const uint64_t* __restrict__ in,
                                             int lo, int hi, int64_t n,
                                             int64_t lane,
                                             uint32_t x[bn::NL]) {
  uint64_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (lo + k < hi) w[k] = in[(int64_t)(lo + k) * n + lane];
  }
  bn::load(w, 1, x);
  bn::to_mont(x);
}

__global__ void __launch_bounds__(LEAF_THREADS, 4)
    bn254_leaf_kernel(const uint64_t* __restrict__ in,
                      uint64_t* __restrict__ out, int w, int64_t n) {
  const int64_t lane = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint32_t s[bn::WIDTH][bn::NL];
  if (w <= 3) {
    pack_to_mont(in, 0, w, n, lane, s[0]);
  } else {
#pragma unroll
    for (int e = 0; e < bn::WIDTH; ++e) {
#pragma unroll
      for (int k = 0; k < bn::NL; ++k) s[e][k] = 0;
    }
    for (int off = 0; off < w; off += 9) {
      const int end = min(off + 9, w);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int lo = off + 3 * j;
        if (lo < end) pack_to_mont(in, lo, min(lo + 3, end), n, lane, s[1 + j]);
      }
      bn::permute(s);
    }
  }
  bn::reduce(s[0], BN_P);
  bn::store(out + lane, n, s[0]);
}

extern "C" int launch_bn254_leaf(const void* in, void* out, int w,
                                 long long n, void* stream) {
  if (n > 0) {
    const long long blocks = (n + LEAF_THREADS - 1) / LEAF_THREADS;
    bn254_leaf_kernel<<<(unsigned)blocks, LEAF_THREADS, 0,
                        (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, w, (int64_t)n);
  }
  return (int)cudaGetLastError();
}
