// The Poseidon-BN254 permutation as __device__ functions, shared by the
// BN254 Merkle-path (K4), leaf-sponge (K5), standalone-permutation (K6) and
// component-probe (K9) kernels.
//
// Replaces the body that halo2_plonky2_verifier_tpu/ops/
// poseidon_bn254_pallas.py inlines into _path_kernel, _leaf_kernel and
// _permute_kernel (_run_rounds).  The function is the circomlib t=4 instance
// (x^5 S-box, 8 full + 56 partial rounds) on Montgomery values (R = 2^256);
// the kernels' outputs equal the plain path of the port
// (ops/poseidon_bn254.py:permute_mont_limbs) bit for bit, because every
// value the kernels write is made canonical first.  The TPU kernels' bf16
// MXU products, Kogge-Stone normalisation and lane tiles are layout tricks
// of that chip and are not carried over.
//
// Schedule: the optimized (go-iden3 / plonky2x) form of
// constants/poseidon_bn254_opt.py, from the generated
// poseidon_bn254_opt_constants.h: full rounds add a constant before and
// after the S-box and mix densely (M, or P once at the transition); a
// partial round is one S-box, one scalar constant and a sparse mix (row 0: a
// dot product of four, one reduction; rows 1-3: s_k + col0_k * s0, one
// product and one reduction each).  Against the naive form that cuts a
// partial round's mix from 16 products and 4 reductions to 7 and 4.
//
// Arithmetic: an Fr value is eight little-endian 32-bit limbs, the width of
// the card's integer multiplier.  A Montgomery product is CIOS (the
// reduction interleaved with the product, one limb of b at a time) on a
// 9-limb window.  A row (window += a * w) takes eight independent wide
// multiply-adds (IMAD.WIDE.U32) and one chain of add.cc / addc.cc that
// carries each high word into the next limb, so the carries ride the carry
// flag instead of being found by comparisons.  (Rows as chains of
// mad.lo.cc / madc.hi.cc lower to two IMADs and two adds a partial product,
// and ran slower.)  A product is 16 rows.  dot4 feeds the four products of
// a matrix row into one window and reduces once.  The S-box squares with
// mont_sqr: the square's 36 distinct products, then REDC of its low half
// (K4 and K9's permutation 5-7% faster than with mont_mul, PERF.md §6).
//
// Lazy values: p < R / 5.29, so a product with both factors below 2p ends
// below p + 4p^2 / R < 1.76p without a final subtraction.  Values stay
// below 2p between operations; after an addition, or where a bound would
// pass 2p, `reduce` subtracts p (or 2p) once if the value is at least that.
// Each bound is stated where the code relies on it.  Kernels call
// `canonical` (or from_mont) before a value leaves them.
//
// Registers: one thread's state is 32 limbs; the widest point is the dense
// mix (old and new state, 64 limbs, and the window).  K4 runs under
// __launch_bounds__(128, 4): 128 registers a thread (60 bytes spill) and
// 16 resident warps an SM; K5's sponge in 256-thread blocks, where the
// compiler keeps 128 registers without a spill.
//
// permute_group4 is the same schedule spread over four lanes of a warp, one
// element each (K6; see there).  leaf_hash, at the end, is K5's
// hash_or_noop of a leaf of Goldilocks words on the one-thread permutation.
//
// Built by a host compiler (no __CUDACC__), the carry-flag primitives are
// plain C++ with the flag in a thread-local variable, so the header's
// arithmetic can be checked on the CPU (tests/test_torch_bn254_opt.py).

#pragma once

#include <cstdint>

#include "poseidon_bn254_constants.h"
#include "poseidon_bn254_opt_constants.h"

namespace bn {

constexpr int NL = 8;                       // 32-bit limbs of one Fr value
constexpr int WIDTH = 4;
constexpr int FULL = 2 * BN_HALF_FULL_ROUNDS;
constexpr int ROUNDS = FULL + BN_PARTIAL_ROUNDS;

// ---------------------------------------------------------------------------
// Carry-flag primitives, named after their PTX instructions.  `_cc` writes
// the carry (for sub: borrow) flag, `c` reads it.
// ---------------------------------------------------------------------------

#if defined(__CUDACC__)

#define BN_OP2(name, ins)                                                   \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) {        \
    uint32_t r;                                                             \
    asm volatile(ins " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));            \
    return r;                                                               \
  }
BN_OP2(add_cc, "add.cc.u32")
BN_OP2(addc_cc, "addc.cc.u32")
BN_OP2(addc, "addc.u32")
BN_OP2(sub_cc, "sub.cc.u32")
BN_OP2(subc_cc, "subc.cc.u32")
BN_OP2(subc, "subc.u32")
#undef BN_OP2

#else  // a host compiler: the same primitives, the flag in a variable

inline thread_local uint32_t carry_flag = 0;

inline uint32_t set_flag(uint64_t s) {
  carry_flag = (uint32_t)(s >> 32) & 1u;
  return (uint32_t)s;
}
inline uint32_t add_cc(uint32_t a, uint32_t b) {
  return set_flag((uint64_t)a + b);
}
inline uint32_t addc_cc(uint32_t a, uint32_t b) {
  return set_flag((uint64_t)a + b + carry_flag);
}
inline uint32_t addc(uint32_t a, uint32_t b) { return a + b + carry_flag; }
inline uint32_t sub_cc(uint32_t a, uint32_t b) {
  return set_flag((uint64_t)a - b);
}
inline uint32_t subc_cc(uint32_t a, uint32_t b) {
  return set_flag((uint64_t)a - b - carry_flag);
}
inline uint32_t subc(uint32_t a, uint32_t b) { return a - b - carry_flag; }

#endif

// ---------------------------------------------------------------------------
// Fr arithmetic on eight limbs
// ---------------------------------------------------------------------------

// A[0..8] += a[0..7] * w.  The eight products p_j = a_j w + A[j] (< 2^64)
// are independent wide multiply-adds; one carry chain then adds each
// product's high word into the next limb.  The caller keeps the result
// below 2^288, so no carry leaves A[8].
__device__ __forceinline__ void row(uint32_t A[NL + 1], const uint32_t* a,
                                    uint32_t w) {
  uint64_t p[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) p[j] = (uint64_t)a[j] * w + A[j];
  A[0] = (uint32_t)p[0];
  A[1] = add_cc((uint32_t)p[1], (uint32_t)(p[0] >> 32));
#pragma unroll
  for (int j = 2; j < NL; ++j)
    A[j] = addc_cc((uint32_t)p[j], (uint32_t)(p[j - 1] >> 32));
  A[NL] = addc(A[NL], (uint32_t)(p[NL - 1] >> 32));
}

// One reduction step: A += m p with m = A[0] (-p^-1) mod 2^32, which clears
// A[0], then A shifts down one limb.  The caller keeps A + m p below 2^288
// (it is for any A < 2^288 - p 2^32).
__device__ __forceinline__ void redc_step(uint32_t A[NL + 1]) {
  row(A, BN_P, A[0] * BN_NP0);
#pragma unroll
  for (int j = 0; j < NL; ++j) A[j] = A[j + 1];
  A[NL] = 0;
}

// r = a b / R mod p, lazily: r < a b / R + p, for a < 4p and any 256-bit b
// (r may alias a or b).  Between steps A < a + p + 1 < 5p < 2^256 (p < R /
// 5.29), within one A + a b_i + m p < 5p 2^32 < 2^288.
__device__ __forceinline__ void mont_mul(const uint32_t* a, const uint32_t* b,
                                         uint32_t r[NL]) {
  uint32_t A[NL + 1];
#pragma unroll
  for (int j = 0; j <= NL; ++j) A[j] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    row(A, a, b[i]);
    redc_step(A);
  }
#pragma unroll
  for (int j = 0; j < NL; ++j) r[j] = A[j];
}

// r = sum_j c_j x_j / R mod p over j < 4 with one reduction, lazily:
// r < sum_j c_j x_j / R + p.  c_j = c[j * NL ..] must be canonical (< p) and
// x_j may be any 256-bit values: the four rows of a step add below
// 4p 2^32, so A stays below 5p between steps and below 2^288 within one.
__device__ __forceinline__ void dot4(const uint32_t* c,
                                     const uint32_t x[WIDTH][NL],
                                     uint32_t r[NL]) {
  uint32_t A[NL + 1];
#pragma unroll
  for (int j = 0; j <= NL; ++j) A[j] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) row(A, c + j * NL, x[j][i]);
    redc_step(A);
  }
#pragma unroll
  for (int j = 0; j < NL; ++j) r[j] = A[j];
}

// x <- x + y; the caller keeps the sum below 2^256.
__device__ __forceinline__ void add(uint32_t x[NL], const uint32_t* y) {
  x[0] = add_cc(x[0], y[0]);
#pragma unroll
  for (int j = 1; j < NL - 1; ++j) x[j] = addc_cc(x[j], y[j]);
  x[NL - 1] = addc(x[NL - 1], y[NL - 1]);
}

// r = a^2 / R mod p, lazily: r <= a^2 / R + p, for a < 4p (r may alias
// a).  The square's 36 distinct products, where mont_mul takes 64: the 28
// off the diagonal once (row i: a_i a_j for j > i, into T[i + j]; row i's
// top limb T[i + 8] is still 0 when it starts), then doubled, then the 8
// squares on the diagonal, each step's carries on the flag, give T = a^2
// in 16 limbs.  The eight reduction steps of from_mont take the low half L
// to u = (L + m p) / R <= p, and r = (T + m p) / R = u + H, H the high
// half: for a < 4p, H < 16 p^2 / R < 3.03p, so r < 2^256.
__device__ __forceinline__ void mont_sqr(const uint32_t* a, uint32_t r[NL]) {
  uint32_t T[2 * NL];
#pragma unroll
  for (int j = 0; j < 2 * NL; ++j) T[j] = 0;
#pragma unroll
  for (int i = 0; i < NL - 1; ++i) {
    uint64_t p[NL];
#pragma unroll
    for (int j = i + 1; j < NL; ++j) p[j] = (uint64_t)a[i] * a[j] + T[i + j];
    T[2 * i + 1] = (uint32_t)p[i + 1];
    if (i + 2 < NL) {
      T[2 * i + 2] = add_cc((uint32_t)p[i + 2], (uint32_t)(p[i + 1] >> 32));
#pragma unroll
      for (int j = i + 3; j < NL; ++j)
        T[i + j] = addc_cc((uint32_t)p[j], (uint32_t)(p[j - 1] >> 32));
      T[i + NL] = addc(0, (uint32_t)(p[NL - 1] >> 32));
    } else {
      T[i + NL] = (uint32_t)(p[NL - 1] >> 32);
    }
  }
  T[1] = add_cc(T[1], T[1]);                // the sum < a^2 / 2: no carry out
#pragma unroll
  for (int j = 2; j < 2 * NL - 1; ++j) T[j] = addc_cc(T[j], T[j]);
  T[2 * NL - 1] = addc(0, 0);
  uint64_t d[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) d[i] = (uint64_t)a[i] * a[i];
  T[0] = (uint32_t)d[0];
  T[1] = add_cc(T[1], (uint32_t)(d[0] >> 32));
#pragma unroll
  for (int i = 1; i < NL - 1; ++i) {
    T[2 * i] = addc_cc(T[2 * i], (uint32_t)d[i]);
    T[2 * i + 1] = addc_cc(T[2 * i + 1], (uint32_t)(d[i] >> 32));
  }
  T[2 * NL - 2] = addc_cc(T[2 * NL - 2], (uint32_t)d[NL - 1]);
  T[2 * NL - 1] = addc(T[2 * NL - 1], (uint32_t)(d[NL - 1] >> 32));
  uint32_t A[NL + 1];
#pragma unroll
  for (int j = 0; j < NL; ++j) A[j] = T[j];
  A[NL] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) redc_step(A);
#pragma unroll
  for (int j = 0; j < NL; ++j) r[j] = A[j];
  add(r, &T[NL]);
}

// x <- x - k if x >= k (k is BN_P or BN_2P): x < 2k becomes x < k, and
// x < 3k becomes x < 2k.
__device__ __forceinline__ void reduce(uint32_t x[NL], const uint32_t* k) {
  uint32_t d[NL];
  d[0] = sub_cc(x[0], k[0]);
#pragma unroll
  for (int j = 1; j < NL; ++j) d[j] = subc_cc(x[j], k[j]);
  const uint32_t borrow = subc(0, 0);       // all ones if x < k
#pragma unroll
  for (int j = 0; j < NL; ++j) x[j] = borrow ? x[j] : d[j];
}

// x <- x * R mod p for any 256-bit x: x R^2 / R < p, so x < 2p out.
__device__ __forceinline__ void to_mont(uint32_t x[NL]) {
  mont_mul(BN_R2, x, x);
}

// x <- x / R mod p, canonical, for any 256-bit x: the reduction steps alone
// give (x + m p) / R <= p, and one subtraction makes that canonical.
__device__ __forceinline__ void from_mont(uint32_t x[NL]) {
  uint32_t A[NL + 1];
#pragma unroll
  for (int j = 0; j < NL; ++j) A[j] = x[j];
  A[NL] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) redc_step(A);
#pragma unroll
  for (int j = 0; j < NL; ++j) x[j] = A[j];
  reduce(x, BN_P);
}

// x <- x^5 for x < 2p: x^2 < 1.76p, x^4 < 1.59p, x^5 < 1.61p.
__device__ __forceinline__ void sbox(uint32_t x[NL]) {
  uint32_t x2[NL], x4[NL];
  mont_sqr(x, x2);
  mont_sqr(x2, x4);
  mont_mul(x4, x, x);
}

// x <- x + c, then below 2p again: x < 2p, c < p.
__device__ __forceinline__ void add_const(uint32_t x[NL], const uint32_t* c) {
  add(x, c);
  reduce(x, BN_P);
}

// u64 words <-> limbs: word k of an Fr value at p[k * stride].
__device__ __forceinline__ void load(const uint64_t* p, int64_t stride,
                                     uint32_t x[NL]) {
#pragma unroll
  for (int k = 0; k < NL / 2; ++k) {
    const uint64_t w = p[k * stride];
    x[2 * k] = (uint32_t)w;
    x[2 * k + 1] = (uint32_t)(w >> 32);
  }
}

__device__ __forceinline__ void store(uint64_t* p, int64_t stride,
                                      const uint32_t x[NL]) {
#pragma unroll
  for (int k = 0; k < NL / 2; ++k)
    p[k * stride] = (uint64_t)x[2 * k] | ((uint64_t)x[2 * k + 1] << 32);
}

// ---------------------------------------------------------------------------
// The permutation, one thread per state (K4, K5, K9)
// ---------------------------------------------------------------------------

// Full round r of FULL: pre-S-box and post-S-box constants (zero where the
// schedule has none), S-boxes, the dense mix of round r.  Elements < 2p in;
// the mix gives < 2p (p + 4 2p p / R) < 2.52p, one subtraction < 1.52p.
__device__ __forceinline__ void full_round(uint32_t s[WIDTH][NL], int r) {
#pragma unroll
  for (int e = 0; e < WIDTH; ++e) {
    add_const(s[e], &BN_OPT_PRE[(r * WIDTH + e) * NL]);
    sbox(s[e]);
    add_const(s[e], &BN_OPT_POST[(r * WIDTH + e) * NL]);
  }
  uint32_t out[WIDTH][NL];
#pragma unroll
  for (int f = 0; f < WIDTH; ++f) {
    dot4(&BN_OPT_MIX[(r * WIDTH + f) * WIDTH * NL], s, out[f]);
    reduce(out[f], BN_P);
  }
#pragma unroll
  for (int e = 0; e < WIDTH; ++e) {
#pragma unroll
    for (int j = 0; j < NL; ++j) s[e][j] = out[e][j];
  }
}

// Partial round i: s0 <- s0^5 + gamma_i (< 2p), then the sparse mix:
// new0 = row0 . s (< 2.52p, one subtraction: < 1.52p) and
// s_k += col0_k s0 (< 2p + 1.38p, one subtraction of 2p: < 2p).
__device__ __forceinline__ void partial_round(uint32_t s[WIDTH][NL], int i) {
  sbox(s[0]);
  add_const(s[0], &BN_OPT_GAMMA[i * NL]);
  uint32_t n0[NL];
  dot4(&BN_OPT_ROW0[i * WIDTH * NL], s, n0);
  reduce(n0, BN_P);
#pragma unroll
  for (int k = 1; k < WIDTH; ++k) {
    uint32_t t[NL];
    mont_mul(&BN_OPT_COL0[(i * (WIDTH - 1) + k - 1) * NL], s[0], t);
    add(s[k], t);
    reduce(s[k], BN_2P);
  }
#pragma unroll
  for (int j = 0; j < NL; ++j) s[0][j] = n0[j];
}

// The permutation of one state in place: elements < 2p in and out.  One
// loop over all rounds, so each round's code exists once.
__device__ __forceinline__ void permute(uint32_t s[WIDTH][NL]) {
  constexpr int H = BN_HALF_FULL_ROUNDS;
#pragma unroll 1
  for (int r = 0; r < ROUNDS; ++r) {
    if (r < H || r >= H + BN_PARTIAL_ROUNDS)
      full_round(s, r < H ? r : r - BN_PARTIAL_ROUNDS);
    else
      partial_round(s, r - H);
  }
}

// Every element < 2p -> canonical.
__device__ __forceinline__ void canonical(uint32_t s[WIDTH][NL]) {
#pragma unroll
  for (int e = 0; e < WIDTH; ++e) reduce(s[e], BN_P);
}

// ---------------------------------------------------------------------------
// The permutation over four lanes of a warp (K6)
// ---------------------------------------------------------------------------

// The schedule's tables, copied to shared memory by K6: there each lane of
// a group reads the entry of its own element, four addresses a warp.
struct OptTables {
  uint32_t pre[sizeof(BN_OPT_PRE) / 4];
  uint32_t post[sizeof(BN_OPT_POST) / 4];
  uint32_t mix[sizeof(BN_OPT_MIX) / 4];
  uint32_t gamma[sizeof(BN_OPT_GAMMA) / 4];
  uint32_t row0[sizeof(BN_OPT_ROW0) / 4];
  uint32_t col0[sizeof(BN_OPT_COL0) / 4];
};

// Copy the tables into `t` with the `count` threads of a block (the caller
// synchronises afterwards).
__device__ __forceinline__ void copy_tables(OptTables& t, int tid,
                                            int count) {
  const uint32_t* src[] = {BN_OPT_PRE, BN_OPT_POST, BN_OPT_MIX,
                           BN_OPT_GAMMA, BN_OPT_ROW0, BN_OPT_COL0};
  uint32_t* dst[] = {t.pre, t.post, t.mix, t.gamma, t.row0, t.col0};
  const int size[] = {sizeof(t.pre) / 4, sizeof(t.post) / 4,
                      sizeof(t.mix) / 4, sizeof(t.gamma) / 4,
                      sizeof(t.row0) / 4, sizeof(t.col0) / 4};
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    for (int q = tid; q < size[a]; q += count) dst[a][q] = src[a][q];
  }
}

__device__ __forceinline__ void shfl(uint32_t y[NL], const uint32_t x[NL],
                                     int src) {
#pragma unroll
  for (int j = 0; j < NL; ++j) y[j] = __shfl_sync(0xffffffffu, x[j], src);
}

// The permutation of one state held by the four lanes base .. base + 3 of a
// warp, lane base + e holding element e (< 2p in and out).  All 32 lanes of
// the warp call it together and every lane runs every instruction; a lane
// keeps what its element needs and drops the rest.
//   Full round: each lane adds, S-boxes and mixes its own element (row e of
//   the matrix), after gathering the four elements with shuffles.
//   Partial round: lane 0 squares s0 while lane k computes u_k = row0_k s_k;
//   lane 0 finishes y0 = s0^5 + gamma and shares it; lane 0 computes
//   row0_0 y0 and lane k col0_k y0 (one product each); the group sums
//   new0 = row0_0 y0 + u_1 + u_2 + u_3 with two xor shuffles, and lane k
//   adds col0_k y0 to s_k.  The chain is four products a round where one
//   thread needs three, a dot of four and three.
__device__ __forceinline__ void permute_group4(uint32_t x[NL], int e,
                                               int base,
                                               const OptTables& t) {
  constexpr int H = BN_HALF_FULL_ROUNDS;
#pragma unroll 1
  for (int r = 0; r < ROUNDS; ++r) {
    if (r < H || r >= H + BN_PARTIAL_ROUNDS) {
      const int f = r < H ? r : r - BN_PARTIAL_ROUNDS;
      add_const(x, &t.pre[(f * WIDTH + e) * NL]);
      sbox(x);
      add_const(x, &t.post[(f * WIDTH + e) * NL]);
      uint32_t s[WIDTH][NL];
#pragma unroll
      for (int j = 0; j < WIDTH; ++j) shfl(s[j], x, base + j);
      dot4(&t.mix[(f * WIDTH + e) * WIDTH * NL], s, x);
      reduce(x, BN_P);                          // < 2.52p -> < 1.52p
    } else {
      const int i = r - H;
      const uint32_t* c = &t.row0[(i * WIDTH + e) * NL];
      uint32_t a[NL], u[NL], y[NL], v[NL], z[NL], o[NL];
#pragma unroll
      for (int j = 0; j < NL; ++j) a[j] = e ? c[j] : x[j];
      mont_mul(a, x, u);                        // lane 0: s0^2; k: row0_k s_k
      mont_mul(u, u, y);                        // lane 0: s0^4
      mont_mul(y, x, y);                        // lane 0: s0^5
      add_const(y, &t.gamma[i * NL]);           // lane 0: y0 < 2p
      shfl(y, y, base);
      c = e ? &t.col0[(i * (WIDTH - 1) + e - 1) * NL] : &t.row0[i * WIDTH * NL];
      mont_mul(c, y, v);                        // < 1.38p
#pragma unroll
      for (int j = 0; j < NL; ++j) z[j] = e ? u[j] : v[j];
#pragma unroll
      for (int d = 1; d < WIDTH; d <<= 1) {     // < 2.76p, then < 4p
#pragma unroll
        for (int j = 0; j < NL; ++j)
          o[j] = __shfl_xor_sync(0xffffffffu, z[j], d);
        add(z, o);
        reduce(z, BN_2P);                       // < 2p
      }
      add(x, v);
      reduce(x, BN_2P);                         // lane k: < 3.38p -> < 2p
#pragma unroll
      for (int j = 0; j < NL; ++j) x[j] = e ? x[j] : z[j];
    }
  }
}

// ---------------------------------------------------------------------------
// The leaf hash_or_noop of w Goldilocks words (K5)
// ---------------------------------------------------------------------------
// Element j of a leaf is the u64 word in[j * stride].  w <= 3: the words
// pack into one Fr (word k = element k, value < 2^192), in Montgomery form.
// Otherwise the sponge: chunks of 9 elements, each triple packed into one Fr
// that overwrites state slot 1 + j (a partial last chunk overwrites only
// the ceil(len / 3) slots it covers; a missing element of a covered slot
// packs as zero), one permutation per chunk; the hash is state[0].

// x <- to_mont(pack(elements lo .. hi - 1)) (< 2p).
__device__ __forceinline__ void pack_to_mont(const uint64_t* in,
                                             int64_t stride, int lo, int hi,
                                             uint32_t x[NL]) {
  uint64_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (lo + k < hi) w[k] = in[(int64_t)(lo + k) * stride];
  }
  load(w, 1, x);
  to_mont(x);
}

// One thread: h <- the leaf's hash (< 2p).
__device__ __forceinline__ void leaf_hash(const uint64_t* in, int64_t stride,
                                          int w, uint32_t h[NL]) {
  if (w <= 3) {
    pack_to_mont(in, stride, 0, w, h);
    return;
  }
  uint32_t s[WIDTH][NL];
#pragma unroll
  for (int e = 0; e < WIDTH; ++e) {
#pragma unroll
    for (int k = 0; k < NL; ++k) s[e][k] = 0;
  }
  for (int off = 0; off < w; off += 3 * (WIDTH - 1)) {
    const int end = min(off + 3 * (WIDTH - 1), w);
#pragma unroll
    for (int j = 0; j < WIDTH - 1; ++j) {
      const int lo = off + 3 * j;
      if (lo < end) pack_to_mont(in, stride, lo, min(lo + 3, end), s[1 + j]);
    }
    permute(s);
  }
#pragma unroll
  for (int k = 0; k < NL; ++k) h[k] = s[0][k];
}

}  // namespace bn
