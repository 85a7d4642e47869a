// K2: the whole Fiat-Shamir duplex sponge of each proof, one proof over a
// group of lanes.
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
// permutations (47-57 on the verifier's path), and a batch gives only B
// chains (1024 or 4096), far fewer than the card holds threads.  So one
// proof's state is spread over G lanes (poseidon_gl.cuh:permute_group):
// a full round's S-boxes run side by side, each lane sums its own rows of
// the mix from shuffled values, and a partial round's row-0 dot product is
// split over the lanes.  That shortens the chain of a permutation and puts
// G times as many warps on the card: at G = 16 and 128 threads a block,
// B = 1024 is 128 blocks of four warps, one block an SM (B = 4096 takes
// G = 4 in two-warp blocks, also one warp a scheduler).  The next
// step's chunk is loaded before the current permutation, so its latency
// hides behind it.  A ragged B runs whole groups: a group past the last
// proof permutes a copy of proof B - 1 and stores nothing.

#include <cuda_runtime.h>

#include "poseidon_gl.cuh"

template <int G, int THREADS>
__global__ void __launch_bounds__(THREADS)
    transcript_kernel(const uint64_t* __restrict__ chunks,
                      const int32_t* __restrict__ mask,
                      uint64_t* __restrict__ ys, int n_steps, int64_t b) {
  __shared__ gl::GroupTables tables;
  gl::copy_group_tables(tables, threadIdx.x, THREADS);
  __syncthreads();
  using Grp = gl::Group<G>;
  constexpr int E = Grp::E;
  const int64_t proof = (blockIdx.x * (int64_t)THREADS + threadIdx.x) / G;
  const int l = threadIdx.x % G;
  const int base = (threadIdx.x % 32) & ~(G - 1);
  const int e0 = Grp::first_element(l);
  const int64_t lane = proof < b ? proof : b - 1;
  const bool store = proof < b && Grp::owns(l);

  uint64_t x[E], next[E];
  bool take[E];
  auto fetch = [&](int s) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int e = e0 + j;
      take[j] = e < 8 && mask[s * 8 + e];
      next[j] = take[j] ? chunks[(int64_t)(s * 8 + e) * b + lane] : 0;
    }
  };
#pragma unroll
  for (int j = 0; j < E; ++j) x[j] = 0;
  if (n_steps > 0) fetch(0);
  for (int s = 0; s < n_steps; ++s) {
#pragma unroll
    for (int j = 0; j < E; ++j)
      if (take[j]) x[j] = next[j];
    if (s + 1 < n_steps) fetch(s + 1);
    gl::permute_group<G>(x, l, base, tables);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int e = e0 + j;
      if (store && e < 8) ys[(int64_t)(s * 8 + e) * b + lane] = x[j];
    }
  }
}

template <int G, int THREADS>
static void launch(const void* chunks, const void* mask, void* ys,
                   int n_steps, long long b, cudaStream_t stream) {
  const long long blocks = (b * G + THREADS - 1) / THREADS;
  transcript_kernel<G, THREADS><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const uint64_t*)chunks, (const int32_t*)mask, (uint64_t*)ys, n_steps,
      (int64_t)b);
}

// 16 lanes a proof while its warps leave each of the card's schedulers at
// most one (B <= 1056 on 132 SMs, the n=2^11 drives' B = 1024): the chain
// of a permutation is then the limit, and the larger group makes it
// shorter.  Past that, 4 lanes (the flagship's B = 4096), which do less
// redundant work (fewer copies of element 0's S-box).
// tools/torch_gl_tune.py times both at B = 1024, 2048 and 4096 on the card.
extern "C" int launch_transcript(const void* chunks, const void* mask,
                                 void* ys, int n_steps, long long b,
                                 void* stream) {
  if (b > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const long long lanes = 32LL * 4 * sms;  // one warp a scheduler
    if (b * 16 <= lanes)
      launch<16, 128>(chunks, mask, ys, n_steps, b, st);
    else
      launch<4, 64>(chunks, mask, ys, n_steps, b, st);
  }
  return (int)cudaGetLastError();
}
