// K0: the Poseidon-Goldilocks permutation as a __device__ function, shared by
// the Merkle-path (K1), transcript (K2) and leaf-sponge (K3) kernels.
//
// Replaces halo2_plonky2_verifier_tpu/ops/poseidon_pallas.py:_permute_planes,
// the body those Pallas kernels inline.  What it computes, bit for bit, is the
// plain plane path of the port (ops/poseidon.py:permute_planes): width 12,
// 4 full + 22 partial + 4 full rounds, x^7 S-box, circulant MDS plus DIAG[0],
// canonical (< p) output.  The TPU kernel's bf16 limb-plane MDS, element-major
// regrouping and lazy reduction are layout tricks of that chip and are not
// carried over: Hopper multiplies 64-bit integers natively, so a product is
// `a * b` plus `__umul64hi(a, b)` and one Goldilocks reduction.
//
// One thread owns one state, 12 u64 values in registers; every loop over the
// state is unrolled so the array never leaves registers.  The round
// constants and the MDS row live in __constant__ memory (every thread of a
// warp reads the same entry, which the constant cache broadcasts).  They come
// from poseidon_gl_constants.h, which ops/_build.py writes into the build
// directory from the port's copy of the constants.

#pragma once

#include <cstdint>

#include "poseidon_gl_constants.h"

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p

__device__ __forceinline__ uint64_t canonicalize(uint64_t a) {
  return a >= P ? a + EPS : a;  // a - p mod 2^64
}

// a + b with b < p; a carry out of 64 bits is + 2^64 = + EPS (mod p).
__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += EPS;
  return canonicalize(s);
}

// (hi * 2^64 + lo) mod p, canonical: 2^96 = -1, 2^64 = EPS.  The same steps
// as ops/goldilocks.py:reduce128, so both agree on every input.
__device__ __forceinline__ uint64_t reduce128(uint64_t hi, uint64_t lo) {
  const uint64_t hh = hi >> 32;
  const uint64_t hl = hi & EPS;
  uint64_t t0 = lo - hh;
  if (lo < hh) t0 -= EPS;
  const uint64_t t1 = (hl << 32) - hl;
  uint64_t s = t0 + t1;
  if (s < t0) s += EPS;
  return canonicalize(s);
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return reduce128(__umul64hi(a, b), a * b);
}

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  const uint64_t x2 = mul(x, x);
  const uint64_t x4 = mul(x2, x2);
  const uint64_t x6 = mul(x4, x2);
  return mul(x6, x);
}

// out[r] = sum_i CIRC[i] * s[(r + i) % 12] + DIAG0 * s[0] * (r == 0), taken
// exactly on 32-bit halves (each half-sum < 2^42) and reduced once.
__device__ __forceinline__ void mds(uint64_t s[12]) {
  uint64_t lo[12], hi[12], out[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    lo[i] = s[i] & EPS;
    hi[i] = s[i] >> 32;
  }
#pragma unroll
  for (int r = 0; r < 12; ++r) {
    uint64_t acc_lo = 0, acc_hi = 0;
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      acc_lo += GL_MDS_CIRC[i] * lo[(r + i) % 12];
      acc_hi += GL_MDS_CIRC[i] * hi[(r + i) % 12];
    }
    if (r == 0) {
      acc_lo += GL_MDS_DIAG0 * lo[0];
      acc_hi += GL_MDS_DIAG0 * hi[0];
    }
    const uint64_t mid = acc_hi + (acc_lo >> 32);
    out[r] = reduce128(mid >> 32, (acc_lo & EPS) | (mid << 32));
  }
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = out[i];
}

__device__ __forceinline__ void full_round(uint64_t s[12], int r) {
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = sbox(add(s[i], GL_RC[r * 12 + i]));
  mds(s);
}

__device__ __forceinline__ void partial_round(uint64_t s[12], int r) {
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = add(s[i], GL_RC[r * 12 + i]);
  s[0] = sbox(s[0]);
  mds(s);
}

__device__ __forceinline__ void poseidon_gl_permute(uint64_t s[12]) {
  constexpr int r0 = GL_HALF_N_FULL_ROUNDS;
  constexpr int r1 = GL_HALF_N_FULL_ROUNDS + GL_N_PARTIAL_ROUNDS;
#pragma unroll 1
  for (int r = 0; r < r0; ++r) full_round(s, r);
#pragma unroll 1
  for (int r = r0; r < r1; ++r) partial_round(s, r);
#pragma unroll 1
  for (int r = r1; r < r1 + r0; ++r) full_round(s, r);
}

}  // namespace gl
