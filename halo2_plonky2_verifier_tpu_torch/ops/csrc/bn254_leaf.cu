// K5: the BN254 leaf hash_or_noop over w Goldilocks elements, one thread
// per leaf.
//
// Replaces halo2_plonky2_verifier_tpu/ops/poseidon_bn254_pallas.py:
// hash_or_noop_mont_planes (kernel body _leaf_kernel).  Plain version and
// wrapper: ops/bn254_kernels.py:hash_or_noop_mont_planes_plain /
// hash_or_noop_mont_planes.
//
// What it computes is poseidon_bn254.cuh's leaf_hash (w <= 3: pack and
// convert, no permutation; else the rate-9 sponge, output state[0]), made
// canonical before it is written: canonical Montgomery form, which K4 takes
// as its node.  Layout: (w, N) u64 planes in, (4, N) out; lanes are the
// fastest axis, so a warp's loads and stores of one row are coalesced.
//
// Bound: the ceil(w / 9) permutations per lane (integer multiplies); the
// input is read once, w * 8 B per lane, a bytes bound some 230 times below
// the operations bound at w = 32, so staging the input is no lever.  The
// body is poseidon_bn254.cuh's one-thread permutation in 128 registers,
// whose rate is the rate its instructions issue at more than the length of
// its chains: spreading a leaf over four lanes (K6's form: four times the
// threads and a shorter chain, but 1.64x the products) and taking row 0's
// dot out of the partial rounds' chain (more work, more live registers)
// both ran slower (tools/torch_bn254_tune.py, PERF.md §6).  What the
// design changes is the launch shape, by w (below).

#include <cuda_runtime.h>

#include "poseidon_bn254.cuh"

template <int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    bn254_leaf_kernel(const uint64_t* __restrict__ in,
                      uint64_t* __restrict__ out, int w, int64_t n) {
  const int64_t lane = blockIdx.x * (int64_t)THREADS + threadIdx.x;
  if (lane >= n) return;
  uint32_t h[bn::NL];
  bn::leaf_hash(in + lane, n, w, h);
  bn::reduce(h, BN_P);
  bn::store(out + lane, n, h);
}

template <int THREADS, int MIN_BLOCKS>
static void launch(const void* in, void* out, int w, long long n,
                   cudaStream_t stream) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  bn254_leaf_kernel<THREADS, MIN_BLOCKS>
      <<<(unsigned)blocks, THREADS, 0, stream>>>(
          (const uint64_t*)in, (uint64_t*)out, w, (int64_t)n);
}

// Two launch shapes, chosen by w: the sponge (w > 3) runs 256-thread blocks
// with no minimum, where the compiler keeps 128 registers without a spill;
// the packing alone (w <= 3, no permutation) runs 128 x 4, the sponge's
// earlier shape, faster there.
extern "C" int launch_bn254_leaf(const void* in, void* out, int w,
                                 long long n, void* stream) {
  if (n > 0) {
    if (w > 3)
      launch<256, 1>(in, out, w, n, (cudaStream_t)stream);
    else
      launch<128, 4>(in, out, w, n, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
