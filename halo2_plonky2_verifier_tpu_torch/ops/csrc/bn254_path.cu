// K4: every BN254 Merkle path of a verification, one thread per path.
//
// Replaces halo2_plonky2_verifier_tpu/ops/poseidon_bn254_pallas.py:
// verify_paths_mont_planes (kernel body _path_kernel) with node_in_mont=True,
// the only form the verifier calls.  Plain version and wrapper:
// ops/bn254_kernels.py:verify_paths_mont_planes_plain /
// verify_paths_mont_planes.
//
// The node enters in canonical Montgomery form (K5's output) and stays in
// Montgomery form, below 2p, across levels.  Per level l where active[l] is
// set: the sibling (standard form, any 256-bit value, so also a tampered one
// >= p) is converted by one Montgomery product with R^2 mod p, which is
// exact for every 256-bit x (x R^2 / R < p, so the result is below 2p and
// congruent to x R); the index bit picks whether the node is the right
// child, the state [0, 0, left, right] is permuted, state[0] becomes the
// node, and the index shifts.  A level that is not active leaves node and
// index unchanged, so the kernel skips its permutation.  At exit the root
// leaves Montgomery form, canonical, in standard form.
//
// Bound: the integer multiplies of up to d_max permutations per lane; the
// memory traffic (32 B of sibling per level per lane, coalesced because
// lanes are the fastest axis) takes under 1% of that time.  The card is full
// (430,080 paths on the verifier's n=2^11 shape), so the rate is the IMAD
// pipe's, kept busy by enough resident warps to hide the carry chains'
// latency.  The body (poseidon_bn254.cuh) is the optimized schedule on
// 32-bit limbs and carry chains, which cuts a permutation's instructions,
// and runs in 128 registers (ptxas spills 28 bytes):
// __launch_bounds__(128, 4) holds 16 warps an SM resident, where the
// earlier 64-bit body took 254 registers and allowed 8
// (tools/torch_bn254_tune.py times other launch shapes).

#include <cuda_runtime.h>

#include "poseidon_bn254.cuh"

constexpr int PATH_THREADS = 128;

__global__ void __launch_bounds__(PATH_THREADS, 4)
    bn254_path_kernel(const uint64_t* __restrict__ node,
                      const uint64_t* __restrict__ sib,
                      const int64_t* __restrict__ idx,
                      const int32_t* __restrict__ active,
                      uint64_t* __restrict__ out, int64_t n, int d_max) {
  const int64_t lane = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint32_t h[bn::NL];
  bn::load(node + lane, n, h);
  uint64_t ix = (uint64_t)idx[lane];
  for (int l = 0; l < d_max; ++l) {
    if (!active[l * n + lane]) continue;
    uint32_t sm[bn::NL];
    bn::load(sib + l * 4 * n + lane, n, sm);
    bn::to_mont(sm);
    const bool right = ix & 1;  // the node is the right child
    uint32_t s[bn::WIDTH][bn::NL];
#pragma unroll
    for (int k = 0; k < bn::NL; ++k) {
      s[0][k] = 0;
      s[1][k] = 0;
      s[2][k] = right ? sm[k] : h[k];
      s[3][k] = right ? h[k] : sm[k];
    }
    bn::permute(s);
#pragma unroll
    for (int k = 0; k < bn::NL; ++k) h[k] = s[0][k];
    ix >>= 1;
  }
  bn::from_mont(h);
  bn::store(out + lane, n, h);
}

extern "C" int launch_bn254_path(const void* node, const void* sib,
                                 const void* idx, const void* active,
                                 void* out, long long n, int d_max,
                                 void* stream) {
  if (n > 0) {
    const long long blocks = (n + PATH_THREADS - 1) / PATH_THREADS;
    bn254_path_kernel<<<(unsigned)blocks, PATH_THREADS, 0,
                        (cudaStream_t)stream>>>(
        (const uint64_t*)node, (const uint64_t*)sib, (const int64_t*)idx,
        (const int32_t*)active, (uint64_t*)out, (int64_t)n, d_max);
  }
  return (int)cudaGetLastError();
}
