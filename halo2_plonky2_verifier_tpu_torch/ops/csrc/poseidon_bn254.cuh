// The Poseidon-BN254 permutation as a __device__ function, shared by the
// BN254 Merkle-path (K4), leaf-sponge (K5) and standalone-permutation (K6)
// kernels.
//
// Replaces the body that halo2_plonky2_verifier_tpu/ops/
// poseidon_bn254_pallas.py inlines into _path_kernel, _leaf_kernel and
// _permute_kernel (_run_rounds).  What it computes, bit for bit, is the plain
// path of the port (ops/poseidon_bn254.py:permute_mont_limbs): the circomlib
// t=4 instance, x^5 S-box, 4 full + 56 partial + 4 full rounds, naive round
// form, every element in canonical Montgomery form (R = 2^256).  Keeping
// every value canonical makes the result depend on the values only, so it
// equals the TPU kernels' output although those keep lazy values up to
// about 2.6p in between; their bf16 MXU products and REDC, the
// Kogge-Stone normalisation and the lane tiles are TPU layout tricks and
// are not carried over.
//
// An Fr element is four little-endian u64 words.  Products are taken on
// 64-bit words with __umul64hi and explicit carries: ptxas lowers each
// 64 x 64 -> 128 product to 32-bit IMADs with carry chains anyway, and the
// word form keeps the carry code short enough to check by reading.  Writing
// the 32-bit PTX madc chains by hand is a later performance step.
//
// Montgomery multiplication is a schoolbook 4 x 4-word product followed by
// a word-serial REDC (separated operand scanning).  The MDS mix adds the
// four 512-bit products of a row first and reduces once (4 p^2 < R p), so a
// round costs 16 wide products + 4 REDCs for the mix.
//
// One thread owns one state, 16 u64 words in registers; loops over words
// and elements are unrolled, the round loops are not (#pragma unroll 1).
// The round constants (64 x 4 Fr, 8 KiB) and the MDS (16 Fr) live in
// __constant__ memory: every thread of a warp reads the same entry.  They
// come from poseidon_bn254_constants.h, which ops/_build.py generates from
// the port's copy of the constants.

#pragma once

#include <cstdint>

#include "poseidon_bn254_constants.h"

namespace bn {

// out = a + b * c + carry, low word; carry <- high word (never overflows:
// (2^64 - 1) + (2^64 - 1)^2 + (2^64 - 1) = 2^128 - 1).
__device__ __forceinline__ void mac(uint64_t a, uint64_t b, uint64_t c,
                                    uint64_t& carry, uint64_t& out) {
  uint64_t lo = b * c;
  uint64_t hi = __umul64hi(b, c);
  lo += a;
  hi += (lo < a);
  lo += carry;
  hi += (lo < carry);
  out = lo;
  carry = hi;
}

// x - p where x >= p, for x < 2p.
__device__ __forceinline__ void cond_sub_p(uint64_t x[4]) {
  uint64_t d[4];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t s = x[j] - BN_P[j];
    const uint64_t b1 = x[j] < BN_P[j];
    d[j] = s - borrow;
    borrow = b1 | (s < borrow);
  }
  if (!borrow) {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = d[j];
  }
}

// t[0..7] = a * b (schoolbook, 512 bits).
__device__ __forceinline__ void mul_wide(const uint64_t a[4],
                                         const uint64_t b[4], uint64_t t[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) mac(t[i + j], a[j], b[i], c, t[i + j]);
    t[i + 4] = c;
  }
}

// acc[0..7] += t[0..7]; the caller keeps the sum below 2^512.
__device__ __forceinline__ void add_wide(uint64_t acc[8], const uint64_t t[8]) {
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint64_t s = acc[k] + t[k];
    const uint64_t c1 = s < acc[k];
    acc[k] = s + c;
    c = c1 | (acc[k] < c);
  }
}

// r = t / R mod p, canonical, for t < R * p.  Each step clears the lowest
// remaining word: t += m * p * 2^(64 i) with m = t[i] * (-p^-1) mod 2^64.
// t + sum m_i p 2^(64 i) < 2 R p < 2^512, so no carry leaves t[7], and the
// top half is < 2p.
__device__ __forceinline__ void redc(uint64_t t[8], uint64_t r[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint64_t m = t[i] * BN_NP0;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) mac(t[i + j], m, BN_P[j], c, t[i + j]);
#pragma unroll
    for (int k = i + 4; k < 8; ++k) {
      t[k] += c;
      c = t[k] < c;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) r[j] = t[4 + j];
  cond_sub_p(r);
}

// r = a * b / R mod p for a * b < R * p (r may alias a or b).
__device__ __forceinline__ void mont_mul(const uint64_t a[4],
                                         const uint64_t b[4], uint64_t r[4]) {
  uint64_t t[8];
  mul_wide(a, b, t);
  redc(t, r);
}

// x <- x * R mod p, for any 256-bit x (x * R2 < R * p).
__device__ __forceinline__ void to_mont(uint64_t x[4]) {
  uint64_t r2[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) r2[j] = BN_R2[j];
  mont_mul(x, r2, x);
}

// x <- x / R mod p.
__device__ __forceinline__ void from_mont(uint64_t x[4]) {
  uint64_t t[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    t[j] = x[j];
    t[4 + j] = 0;
  }
  redc(t, x);
}

// x <- (x + c) mod p for canonical x and c (the sum is < 2p < 2^255).
__device__ __forceinline__ void add_mod(uint64_t x[4], const uint64_t* c) {
  uint64_t carry = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t s = x[j] + c[j];
    const uint64_t c1 = s < x[j];
    x[j] = s + carry;
    carry = c1 | (x[j] < carry);
  }
  cond_sub_p(x);
}

__device__ __forceinline__ void sbox5(uint64_t x[4]) {
  uint64_t x2[4], x4[4];
  mont_mul(x, x, x2);
  mont_mul(x2, x2, x4);
  mont_mul(x4, x, x);
}

// s[f] <- sum_e MDS[f][e] * s[e] / R, one REDC per row.
__device__ __forceinline__ void mds(uint64_t s[4][4]) {
  uint64_t out[4][4];
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    uint64_t acc[8], t[8];
    mul_wide(&BN_MDS[(f * 4 + 0) * 4], s[0], acc);
#pragma unroll
    for (int e = 1; e < 4; ++e) {
      mul_wide(&BN_MDS[(f * 4 + e) * 4], s[e], t);
      add_wide(acc, t);
    }
    redc(acc, out[f]);
  }
#pragma unroll
  for (int f = 0; f < 4; ++f) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[f][j] = out[f][j];
  }
}

__device__ __forceinline__ void full_round(uint64_t s[4][4], int r) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    add_mod(s[e], &BN_RC[(r * 4 + e) * 4]);
    sbox5(s[e]);
  }
  mds(s);
}

__device__ __forceinline__ void partial_round(uint64_t s[4][4], int r) {
#pragma unroll
  for (int e = 0; e < 4; ++e) add_mod(s[e], &BN_RC[(r * 4 + e) * 4]);
  sbox5(s[0]);
  mds(s);
}

// The permutation of one canonical Montgomery state, in place.
__device__ __forceinline__ void poseidon_bn254_permute(uint64_t s[4][4]) {
  constexpr int r0 = BN_HALF_FULL_ROUNDS;
  constexpr int r1 = BN_HALF_FULL_ROUNDS + BN_PARTIAL_ROUNDS;
#pragma unroll 1
  for (int r = 0; r < r0; ++r) full_round(s, r);
#pragma unroll 1
  for (int r = r0; r < r1; ++r) partial_round(s, r);
#pragma unroll 1
  for (int r = r1; r < r1 + r0; ++r) full_round(s, r);
}

}  // namespace bn
