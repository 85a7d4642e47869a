// K0: the Poseidon-Goldilocks permutation as __device__ functions, shared by
// the Merkle-path (K1), transcript (K2), leaf-sponge (K3), bulk (K7) and
// chained (K8) kernels.
//
// Replaces halo2_plonky2_verifier_tpu/ops/poseidon_pallas.py:_permute_planes,
// the body those Pallas kernels inline.  What it computes, bit for bit, is the
// plain plane path of the port (ops/poseidon.py:permute_planes_plain): width
// 12, 4 full + 22 partial + 4 full rounds, x^7 S-box, circulant MDS plus
// DIAG[0], canonical (< p) output from any u64 input.  The TPU kernel's bf16
// limb-plane MDS, element-major regrouping and lazy reduction are layout
// tricks of that chip and are not carried over.
//
// The schedule is plonky2's fast partial layer
// (constants/poseidon_goldilocks_opt.py, checked against the naive one by
// ops/poseidon.py:permute_planes_opt_plain): the full rounds are the naive
// ones; the partial layer adds GL_FIRST, applies the 11 x 11 entry matrix
// GL_INIT, and each partial round is the S-box of element 0, its scalar
// GL_PARTIAL[i] and a sparse mix (row 0 GL_W_HAT[i], column 0 GL_V[i]).
//
// Arithmetic.  Hopper has no 64-bit multiplier: a 64 x 64 product is four
// 32 x 32 -> 64 multiply-adds (a square three), and every product is
// written out on 32-bit halves so that the compiler emits exactly those.
// The MDS circulant is compile-time (gl_mds_circ, every entry < 2^6), so a
// term of the mix is one 32 x 32 multiply-add on a half and a row is summed
// exactly on the halves and reduced once.  Values between steps are lazy:
// any u64 is a valid representative, and every step (reduce128_lazy,
// add_lazy) takes any u64 and returns one; canonicalize runs where a value
// must be < p (acc_reduce's subtraction, the output).  The reduction keeps
// the steps of ops/goldilocks.py:reduce128.
//
// Two forms of the permutation:
//   poseidon_gl_permute   one thread owns one state, 12 u64 in registers
//                         (throughput: K1, K3, K7, K8).  Round constants
//                         and tables are read from __constant__ memory at
//                         warp-uniform indices; the caller picks how far the
//                         partial rounds unroll (K1 all 22, else a loop).
//   permute_group<G>      one state spread over G lanes of a warp (latency:
//                         K2).  G = 4: three elements a lane; G = 16: one,
//                         lanes 12..15 mirror lanes 0..3 (a mirror lane adds
//                         nothing).  A full round's S-boxes run side by
//                         side and each lane sums its own rows of the mix
//                         from values gathered with __shfl_sync; in a
//                         partial round every lane runs element 0's S-box
//                         on its own copy (no divergence), and row 0's dot
//                         product is split over the lanes and summed with a
//                         butterfly of shuffles that leaves it in every lane.
//                         The per-element tables are read from shared memory
//                         (GroupTables), as each lane reads its own entries.
//
// Built by a host compiler (no __CUDACC__), the three PTX blocks (the
// reduction's borrow and carry chain, acc_add, acc_add_acc) run the same
// steps in plain C++, so the header can be checked on the CPU
// (tests/gl_body_host.cpp, tests/test_torch_gl_opt.py).

#pragma once

#include <cstdint>

#include "poseidon_gl_constants.h"

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p
constexpr int W = 12;
constexpr int HALF = GL_HALF_N_FULL_ROUNDS;
constexpr int NP = GL_N_PARTIAL_ROUNDS;
constexpr int ROUNDS = 2 * HALF + NP;

__device__ __forceinline__ uint64_t canonicalize(uint64_t a) {
  return a >= P ? a + EPS : a;  // a - p mod 2^64
}

// a + b for any u64 a and b < p; a carry out of 64 bits is + 2^64 = + EPS
// (mod p), and then a + b - 2^64 < b, so adding EPS cannot carry again.
__device__ __forceinline__ uint64_t add_lazy(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += EPS;
  return s;
}

// (hi * 2^64 + lo) mod p as some u64 (maybe >= p): 2^96 = -1, 2^64 = EPS.
// The steps of ops/goldilocks.py:reduce128 before its canonicalize:
//   t = lo - hh, minus EPS more if that borrows (t cannot borrow again);
//   s = t + hl * EPS, plus EPS more if that carries (s cannot carry again);
// on 32-bit words whose borrow and carry flags pick the corrections, so no
// compare is needed.  On the card it is one PTX block; a host compiler runs
// the same steps with the flags in variables.
__device__ __forceinline__ uint64_t reduce128_lazy(uint64_t hi, uint64_t lo) {
  const uint32_t l0 = (uint32_t)lo, l1 = (uint32_t)(lo >> 32);
  const uint32_t hl = (uint32_t)hi, hh = (uint32_t)(hi >> 32);
  uint32_t s0, s1;
#if defined(__CUDACC__)
  asm("{\n\t"
      ".reg .u32 t0, t1, u0, u1, m, z;\n\t"
      "mov.u32 z, 0;\n\t"
      "sub.cc.u32 t0, %2, %5;\n\t"      // t = lo - hh
      "subc.cc.u32 t1, %3, z;\n\t"
      "subc.u32 m, z, z;\n\t"           // m = all ones after a borrow
      "sub.cc.u32 t0, t0, m;\n\t"       // t -= EPS after a borrow
      "subc.u32 t1, t1, z;\n\t"
      "sub.cc.u32 u0, z, %4;\n\t"       // u = hl * 2^32 - hl
      "subc.u32 u1, %4, z;\n\t"
      "add.cc.u32 %0, t0, u0;\n\t"      // s = t + u
      "addc.cc.u32 %1, t1, u1;\n\t"
      "addc.u32 m, z, z;\n\t"
      "neg.s32 m, m;\n\t"               // m = all ones after a carry
      "add.cc.u32 %0, %0, m;\n\t"       // s += EPS after a carry
      "addc.u32 %1, %1, z;\n\t"
      "}"
      : "=r"(s0), "=r"(s1)
      : "r"(l0), "r"(l1), "r"(hl), "r"(hh));
#else
  uint64_t d = (uint64_t)l0 - hh;
  uint32_t t0 = (uint32_t)d;
  d = (uint64_t)l1 - (uint32_t)(d >> 63);
  uint32_t t1 = (uint32_t)d;
  uint32_t m = 0u - (uint32_t)(d >> 63);
  d = (uint64_t)t0 - m;
  t0 = (uint32_t)d;
  t1 = t1 - (uint32_t)(d >> 63);
  d = 0ull - hl;
  const uint32_t u0 = (uint32_t)d;
  const uint32_t u1 = hl - (uint32_t)(d >> 63);
  d = (uint64_t)t0 + u0;
  s0 = (uint32_t)d;
  d = (uint64_t)t1 + u1 + (d >> 32);
  s1 = (uint32_t)d;
  m = 0u - (uint32_t)(d >> 32);
  d = (uint64_t)s0 + m;
  s0 = (uint32_t)d;
  s1 = s1 + (uint32_t)(d >> 32);
#endif
  return ((uint64_t)s1 << 32) | s0;
}

// (hi * 2^64 + lo) mod p, canonical: ops/goldilocks.py:reduce128.
__device__ __forceinline__ uint64_t reduce128(uint64_t hi, uint64_t lo) {
  return canonicalize(reduce128_lazy(hi, lo));
}

// a * b + c exactly, as hi * 2^64 + lo, for any u64 a, b, c: four 32 x 32
// -> 64 multiply-adds, each sum below 2^64.
__device__ __forceinline__ void mul_add_wide(uint64_t a, uint64_t b,
                                             uint64_t c, uint64_t& hi,
                                             uint64_t& lo) {
  const uint32_t a0 = (uint32_t)a, a1 = (uint32_t)(a >> 32);
  const uint32_t b0 = (uint32_t)b, b1 = (uint32_t)(b >> 32);
  const uint64_t ll = (uint64_t)a0 * b0 + (uint32_t)c;
  const uint64_t lh = (uint64_t)a0 * b1 + (ll >> 32) + (c >> 32);
  const uint64_t hl = (uint64_t)a1 * b0 + (uint32_t)lh;
  hi = (uint64_t)a1 * b1 + (lh >> 32) + (hl >> 32);
  lo = (hl << 32) | (uint32_t)ll;
}

// a * a exactly: three 32 x 32 -> 64 products (a0 a1 once).
__device__ __forceinline__ void sqr_wide(uint64_t a, uint64_t& hi,
                                         uint64_t& lo) {
  const uint32_t a0 = (uint32_t)a, a1 = (uint32_t)(a >> 32);
  const uint64_t ll = (uint64_t)a0 * a0;
  const uint64_t m = (uint64_t)a0 * a1;
  const uint64_t lh = m + (ll >> 32);
  const uint64_t hl = m + (uint32_t)lh;
  hi = (uint64_t)a1 * a1 + (lh >> 32) + (hl >> 32);
  lo = (hl << 32) | (uint32_t)ll;
}

__device__ __forceinline__ uint64_t mul_lazy(uint64_t a, uint64_t b) {
  uint64_t hi, lo;
  mul_add_wide(a, b, 0, hi, lo);
  return reduce128_lazy(hi, lo);
}

__device__ __forceinline__ uint64_t sqr_lazy(uint64_t a) {
  uint64_t hi, lo;
  sqr_wide(a, hi, lo);
  return reduce128_lazy(hi, lo);
}

// x^7 = x^4 x^3: two squares and two products, three deep.
__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  const uint64_t x2 = sqr_lazy(x);
  const uint64_t x3 = mul_lazy(x2, x);
  const uint64_t x4 = sqr_lazy(x2);
  return mul_lazy(x4, x3);
}

// A sum of up to 2^32 products below 2^128: top * 2^128 + hi * 2^64 + lo.
struct Acc {
  uint64_t lo, hi;
  uint32_t top;
};

__device__ __forceinline__ void acc_add(Acc& a, uint64_t hi, uint64_t lo) {
#if defined(__CUDACC__)
  asm("add.cc.u64 %0, %0, %3;\n\t"
      "addc.cc.u64 %1, %1, %4;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+l"(a.lo), "+l"(a.hi), "+r"(a.top)
      : "l"(lo), "l"(hi));
#else
  const unsigned __int128 x = ((unsigned __int128)a.hi << 64) | a.lo;
  const unsigned __int128 s = x + (((unsigned __int128)hi << 64) | lo);
  a.top += s < x;
  a.lo = (uint64_t)s;
  a.hi = (uint64_t)(s >> 64);
#endif
}

// a += b (the caller keeps the sum below 2^160).
__device__ __forceinline__ void acc_add_acc(Acc& a, const Acc& b) {
#if defined(__CUDACC__)
  asm("add.cc.u64 %0, %0, %3;\n\t"
      "addc.cc.u64 %1, %1, %4;\n\t"
      "addc.u32 %2, %2, %5;"
      : "+l"(a.lo), "+l"(a.hi), "+r"(a.top)
      : "l"(b.lo), "l"(b.hi), "r"(b.top));
#else
  const uint32_t top = a.top + b.top;
  a.top = 0;
  acc_add(a, b.hi, b.lo);
  a.top += top;
#endif
}

// a += x * c for any u64 x and c.
__device__ __forceinline__ void acc_mul(Acc& a, uint64_t x, uint64_t c) {
  uint64_t hi, lo;
  mul_add_wide(x, c, 0, hi, lo);
  acc_add(a, hi, lo);
}

// The sum mod p, canonical: 2^128 = -2^32 (mod p), and top << 32 < p.
__device__ __forceinline__ uint64_t acc_reduce(const Acc& a) {
  const uint64_t r = reduce128(a.hi, a.lo);
  const uint64_t t = (uint64_t)a.top << 32;
  return r >= t ? r - t : r - t - EPS;  // r - t + p (mod 2^64)
}

// A mix row summed exactly on 32-bit halves: value = sum_hi * 2^32 +
// sum_lo, both below 2^42, reduced once (lazy).
__device__ __forceinline__ uint64_t reduce_halves(uint64_t sum_lo,
                                                  uint64_t sum_hi) {
  const uint64_t mid = sum_hi + (sum_lo >> 32);
  return reduce128_lazy(mid >> 32, (sum_lo & EPS) | (mid << 32));
}

// ---------------------------------------------------------------------------
// One thread, one state
// ---------------------------------------------------------------------------

// s = M s: out[r] = sum_i CIRC[i] * s[(r + i) % 12] + DIAG0 * s[0] (r = 0).
__device__ __forceinline__ void mds(uint64_t s[W]) {
  uint64_t out[W];
#pragma unroll
  for (int r = 0; r < W; ++r) {
    uint64_t sum_lo = 0, sum_hi = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint64_t x = s[(r + i) % W];
      sum_lo += (uint64_t)(uint32_t)x * gl_mds_circ(i);
      sum_hi += (x >> 32) * gl_mds_circ(i);
    }
    if (r == 0) {
      sum_lo += (uint64_t)(uint32_t)s[0] * GL_MDS_DIAG0;
      sum_hi += (s[0] >> 32) * GL_MDS_DIAG0;
    }
    out[r] = reduce_halves(sum_lo, sum_hi);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = out[i];
}

__device__ __forceinline__ void full_round(uint64_t s[W], int r) {
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = sbox(add_lazy(s[i], GL_RC[r * W + i]));
  mds(s);
}

// The entry of the partial layer: s += FIRST, s[1:] = INIT s[1:].
__device__ __forceinline__ void partial_entry(uint64_t s[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = add_lazy(s[i], GL_FIRST[i]);
  uint64_t t[W];
#pragma unroll
  for (int k = 1; k < W; ++k) {
    Acc a = {0, 0, 0};
#pragma unroll
    for (int c = 1; c < W; ++c) acc_mul(a, s[c], GL_INIT[k * W + c]);
    t[k] = acc_reduce(a);
  }
#pragma unroll
  for (int k = 1; k < W; ++k) s[k] = t[k];
}

// Partial round i: y = sbox(s0) + PARTIAL[i]; s0 = M00 y + W_HAT[i] . s
// (over s[1:] before the update); s_k += V[i][k] y.  The dot product over
// s[1:] does not wait for the S-box.
__device__ __forceinline__ void partial_round(uint64_t s[W], int i) {
  const uint64_t y = add_lazy(sbox(s[0]), GL_PARTIAL[i]);
  Acc a = {0, 0, 0};
#pragma unroll
  for (int k = 1; k < W; ++k) acc_mul(a, s[k], GL_W_HAT[i * W + k]);
  acc_mul(a, y, GL_MDS_M00);
#pragma unroll
  for (int k = 1; k < W; ++k) {
    uint64_t hi, lo;
    mul_add_wide(y, GL_V[i * W + k], s[k], hi, lo);
    s[k] = reduce128_lazy(hi, lo);
  }
  s[0] = acc_reduce(a);
}

// The rounds are loops, except that PARTIAL_UNROLL partial rounds unroll
// into one loop body (their constants then constant-bank operands, not
// warp-uniform loads).
template <int PARTIAL_UNROLL = 1>
__device__ __forceinline__ void poseidon_gl_permute(uint64_t s[W]) {
#pragma unroll 1
  for (int r = 0; r < HALF; ++r) full_round(s, r);
  partial_entry(s);
#pragma unroll (PARTIAL_UNROLL)
  for (int i = 0; i < NP; ++i) partial_round(s, i);
#pragma unroll 1
  for (int r = HALF + NP; r < ROUNDS; ++r) full_round(s, r);
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = canonicalize(s[i]);
}

// ---------------------------------------------------------------------------
// One state over a group of G lanes (K2)
// ---------------------------------------------------------------------------

// The tables each lane reads at its own elements, twelve entries a row as
// in poseidon_gl_constants.h.
struct GroupTables {
  uint64_t rc[ROUNDS * W];
  uint64_t first[W];
  uint64_t init[W * W];
  uint64_t w_hat[NP * W];
  uint64_t v[NP * W];
};

// Thread tid of n fills its share of t from __constant__ memory; the
// caller synchronises before use.
__device__ __forceinline__ void copy_group_tables(GroupTables& t, int tid,
                                                  int n) {
  for (int k = tid; k < ROUNDS * W; k += n) t.rc[k] = GL_RC[k];
  for (int k = tid; k < W; k += n) t.first[k] = GL_FIRST[k];
  for (int k = tid; k < W * W; k += n) t.init[k] = GL_INIT[k];
  for (int k = tid; k < NP * W; k += n) {
    t.w_hat[k] = GL_W_HAT[k];
    t.v[k] = GL_V[k];
  }
}

__device__ __forceinline__ uint64_t shfl64(uint64_t v, int src) {
  const uint32_t lo = __shfl_sync(0xffffffffu, (uint32_t)v, src);
  const uint32_t hi = __shfl_sync(0xffffffffu, (uint32_t)(v >> 32), src);
  return ((uint64_t)hi << 32) | lo;
}

__device__ __forceinline__ uint64_t shfl_xor64(uint64_t v, int mask) {
  const uint32_t lo = __shfl_xor_sync(0xffffffffu, (uint32_t)v, mask);
  const uint32_t hi = __shfl_xor_sync(0xffffffffu, (uint32_t)(v >> 32), mask);
  return ((uint64_t)hi << 32) | lo;
}

// Lane layout of a group of G lanes: E elements a lane, lane l holding
// elements first_element(l) + j for j < E.
template <int G>
struct Group {
  static_assert(G == 4 || G == 16, "a group is 4 or 16 lanes");
  static constexpr int E = G == 4 ? 3 : 1;
  __device__ static int first_element(int l) { return (l % (W / E)) * E; }
  // Whether lane l adds its elements into row 0's dot product (the lanes
  // past 12 / E mirror the first ones).
  __device__ static bool owns(int l) { return l < W / E; }
  // The warp lane holding element (e0 + m) % 12 in its slot m % E, for
  // the lane whose first element is e0 (E divides e0).
  __device__ static int src(int base, int e0, int m) {
    return base + ((e0 + m) % W) / E;
  }
};

// One full round on a group: S-boxes side by side, then each lane's rows
// of the mix from all twelve elements, gathered in the order
// y[m] = s[(e0 + m) % 12], so that row e0 + j weighs y[m] by
// CIRC[(m - j) % 12] (a compile-time constant).
template <int G>
__device__ __forceinline__ void group_full_round(uint64_t x[], int e0,
                                                 int base, int r,
                                                 const GroupTables& t) {
  constexpr int E = Group<G>::E;
#pragma unroll
  for (int j = 0; j < E; ++j) x[j] = sbox(add_lazy(x[j], t.rc[r * W + e0 + j]));
  uint64_t sum_lo[E], sum_hi[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const uint32_t d = e0 == 0 && j == 0 ? GL_MDS_DIAG0 : 0u;
    sum_lo[j] = (uint64_t)(uint32_t)x[j] * d;
    sum_hi[j] = (x[j] >> 32) * d;
  }
#pragma unroll
  for (int m = 0; m < W; ++m) {
    const uint64_t y =
        m < E ? x[m % E] : shfl64(x[m % E], Group<G>::src(base, e0, m));
#pragma unroll
    for (int j = 0; j < E; ++j) {
      sum_lo[j] += (uint64_t)(uint32_t)y * gl_mds_circ((m - j + W) % W);
      sum_hi[j] += (y >> 32) * gl_mds_circ((m - j + W) % W);
    }
  }
#pragma unroll
  for (int j = 0; j < E; ++j) x[j] = reduce_halves(sum_lo[j], sum_hi[j]);
}

// The row-0 dot product w . s over the group, unreduced, in every lane:
// each lane's share over its elements (w[0] is zero; a lane that mirrors
// another adds zeros), then a butterfly of shuffles of the 160-bit sums, so
// that the one reduction waits for the S-box and not for the butterfly.
template <int G>
__device__ __forceinline__ Acc group_dot(const uint64_t x[], int l, int e0,
                                         const uint64_t* w) {
  const bool owns = Group<G>::owns(l);
  Acc a = {0, 0, 0};
#pragma unroll
  for (int j = 0; j < Group<G>::E; ++j)
    acc_mul(a, x[j], owns ? w[e0 + j] : 0);
#pragma unroll
  for (int o = 1; o < G; o <<= 1) {
    const Acc b = {shfl_xor64(a.lo, o), shfl_xor64(a.hi, o),
                   __shfl_xor_sync(0xffffffffu, a.top, o)};
    acc_add_acc(a, b);
  }
  return a;
}

// The permutation of the state whose elements e0 + j (j < E) lane l holds
// in x; `base` is the warp lane of the group's lane 0.  Every lane of the
// warp must call it (the shuffles name the whole warp).
template <int G>
__device__ __forceinline__ void permute_group(uint64_t x[], int l, int base,
                                              const GroupTables& t) {
  constexpr int E = Group<G>::E;
  const int e0 = Group<G>::first_element(l);
#pragma unroll 1
  for (int r = 0; r < HALF; ++r) group_full_round<G>(x, e0, base, r, t);

  // Entry of the partial layer: x += FIRST, then each lane's rows of the
  // bordered INIT from all twelve elements (row 0 keeps element 0).  x0 is
  // every lane's copy of element 0.
#pragma unroll
  for (int j = 0; j < E; ++j) x[j] = add_lazy(x[j], t.first[e0 + j]);
  Acc a[E];
#pragma unroll
  for (int j = 0; j < E; ++j) a[j] = {0, 0, 0};
  uint64_t x0 = 0;
#pragma unroll
  for (int c = 0; c < W; ++c) {
    const uint64_t z = shfl64(x[c % E], base + c / E);
    if (c == 0) x0 = z;
#pragma unroll
    for (int j = 0; j < E; ++j) acc_mul(a[j], z, t.init[(e0 + j) * W + c]);
  }
#pragma unroll
  for (int j = 0; j < E; ++j) x[j] = acc_reduce(a[j]);

#pragma unroll 1
  for (int i = 0; i < NP; ++i) {
    // as partial_round; the dot product's share and butterfly do not wait
    // for the S-box
    const uint64_t y = add_lazy(sbox(x0), GL_PARTIAL[i]);
    Acc d = group_dot<G>(x, l, e0, t.w_hat + i * W);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      uint64_t hi, lo;
      mul_add_wide(y, t.v[i * W + e0 + j], x[j], hi, lo);
      x[j] = reduce128_lazy(hi, lo);
    }
    acc_mul(d, y, GL_MDS_M00);
    x0 = acc_reduce(d);
    if (e0 == 0) x[0] = x0;
  }

#pragma unroll 1
  for (int r = HALF + NP; r < ROUNDS; ++r)
    group_full_round<G>(x, e0, base, r, t);
#pragma unroll
  for (int j = 0; j < E; ++j) x[j] = canonicalize(x[j]);
}

// ---------------------------------------------------------------------------
// The leaf sponge (K3), one thread a leaf
// ---------------------------------------------------------------------------

// plonky2's hash_n_to_m_no_pad of the w words in[k * n + lane] (k < w; the
// leaf's column of (w, n) planes): overwrite-mode absorb at rate 8, each
// chunk of up to 8 words replacing the front of the state, then one
// permutation; out <- state[0:4].  w = 0 gives zeros, as the plain version.
template <int PARTIAL_UNROLL = 1>
__device__ __forceinline__ void leaf_sponge(const uint64_t* in, int64_t n,
                                            int64_t lane, int w,
                                            uint64_t out[4]) {
  uint64_t s[W];
#pragma unroll
  for (int k = 0; k < W; ++k) s[k] = 0;
  for (int off = 0; off < w; off += 8) {
    const int len = w - off < 8 ? w - off : 8;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k < len) s[k] = in[(int64_t)(off + k) * n + lane];
    }
    poseidon_gl_permute<PARTIAL_UNROLL>(s);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = s[k];
}

}  // namespace gl
