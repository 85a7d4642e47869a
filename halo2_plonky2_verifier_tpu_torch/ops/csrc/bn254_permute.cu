// K6: the standalone Poseidon-BN254 permutation, four lanes per state.
//
// Replaces halo2_plonky2_verifier_tpu/ops/poseidon_bn254_pallas.py:
// permute_mont_planes (kernel body _permute_kernel), which the JAX package's
// BN254 transcript reaches once per sponge step through
// ops/poseidon_bn254.py:permute_mont -> permute_mont_batchlast.  Plain
// version and wrapper: ops/bn254_kernels.py:permute_planes_plain /
// permute_planes.
//
// Layout: (16, N) u64 planes, row 4 * e + k = word k of state element e,
// canonical Montgomery form in and out; lanes are the fastest axis.
//
// Bound: on the verifier's path N is the batch (4096 proofs) and each
// transcript step is one launch, whose steps are chained, so the time is
// the latency of one permutation, not the card's multiply rate (65x that
// bound with one thread per state: 128 warps for 132 SMs, one dependent
// chain each).  Four lanes share a state here, lane e holding element e
// (poseidon_bn254.cuh:permute_group4): a full round's four S-boxes and four
// mix rows run side by side, and a partial round's chain is four products
// where one thread needs ten.  N = 4096 gives 512 warps, one block of four
// warps an SM, one warp per scheduler.  The schedule's tables go to shared
// memory first, where the four lanes of a group read their own element's
// entries.  A ragged N leaves the last group partial: every lane runs (the
// shuffles need the whole warp), an idle group permutes a copy of state
// N - 1, and only lanes with a state store.

#include <cuda_runtime.h>

#include "poseidon_bn254.cuh"

constexpr int PERMUTE_THREADS = 128;     // 32 states a block

__global__ void __launch_bounds__(PERMUTE_THREADS)
    bn254_permute_kernel(const uint64_t* __restrict__ in,
                         uint64_t* __restrict__ out, int64_t n) {
  __shared__ bn::OptTables tables;
  bn::copy_tables(tables, threadIdx.x, PERMUTE_THREADS);
  __syncthreads();
  const int64_t state = (blockIdx.x * (int64_t)PERMUTE_THREADS +
                         threadIdx.x) / bn::WIDTH;
  const int e = threadIdx.x % bn::WIDTH;
  const int base = (threadIdx.x % 32) & ~(bn::WIDTH - 1);
  const int64_t lane = state < n ? state : n - 1;
  uint32_t x[bn::NL];
  bn::load(in + e * 4 * n + lane, n, x);
  bn::permute_group4(x, e, base, tables);
  bn::reduce(x, BN_P);
  if (state < n) bn::store(out + e * 4 * n + lane, n, x);
}

extern "C" int launch_bn254_permute(const void* in, void* out, long long n,
                                    void* stream) {
  if (n > 0) {
    const long long blocks =
        (n * bn::WIDTH + PERMUTE_THREADS - 1) / PERMUTE_THREADS;
    bn254_permute_kernel<<<(unsigned)blocks, PERMUTE_THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, (int64_t)n);
  }
  return (int)cudaGetLastError();
}
