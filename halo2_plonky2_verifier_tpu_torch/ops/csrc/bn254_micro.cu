// K9: component probes of the Poseidon-BN254 permutation, one thread per
// lane, the probe's id a launch argument.
//
// Replaces tools/bn254_micro.py:probe (its inner kernel and pallas_call),
// which times CHAIN dependent iterations of one part of the TPU permutation.
// Plain version and wrapper: ops/bn254_micro_kernels.py:run_probe_plain /
// run_probe; the probes' table, with what each computes, is there.
//
// Each thread runs `chain` dependent iterations of one part of the BN254
// permutation on its own lane's Fr values, canonical Montgomery form in and
// out, so every probe computes a defined function that its plain version
// reproduces exactly (the TPU probe clamped u16 limbs to keep its chains
// alive).  PERMUTE times the K4-K6 body (poseidon_bn254.cuh:permute, the
// optimized schedule).  The other Fr probes time the naive round's parts
// (the dense MDS mix, the naive partial round with all four round
// constants), built below from the body's primitives (mont_mul, dot4,
// reduce) and made canonical after every step, as their plain versions
// are.  Two probes time the bare multipliers: 16 dependent u32 multiplies,
// and 16 dependent f32 multiplies taken with __fmul_rn so that no FMA
// contraction changes the rounding; their values start from the low 16 bits
// of the input word.
//
// Layout: (rows, N) u64 planes, row 4 * e + k = word k of Fr element e; lanes
// are the fastest axis.  Each probe is its own template instance, so each
// gets its own register allocation; every instance runs under
// __launch_bounds__(THREADS, 512 / THREADS), the 128-register budget of K4
// and K5 (PARTIAL_X2, whose two states would spill there, under twice
// that), and the whole permutation is also built for 256 and 512 threads
// per block (the counterpart of the TPU tile sweep).
//
// Bound: the probe's multiplies (32-bit IMADs; f32 multiplies for the f32
// probe), chain per lane; the memory traffic is one read and one write of the
// lane's rows.

#include <cuda_runtime.h>

#include "poseidon_bn254.cuh"

enum Probe {
  SQR_REDC = 0,     // x <- x * x / R (the S-box's squaring stage)
  MONT_MUL = 1,     // x <- x * c / R, c = element 1, kept
  REDC = 2,         // x <- x / R
  MIX = 3,          // s <- the dense 4 x 4 MDS mix, one REDC per row
  PARTIAL = 4,      // s <- partial round HALF + i % PARTIAL_ROUNDS
  PARTIAL_X2 = 5,   // the same on two states per thread
  PERMUTE = 6,      // s <- the whole permutation
  U32_MUL16 = 7,    // 16 x: x = (x * (x ^ j)) & 0xFFFF | 1
  F32_MUL16 = 8,    // 16 x: x = fmod(x * (x + j + 1), 65536) + 1
};

// Fr elements per lane.
__host__ __device__ constexpr int probe_elems(int p) {
  return p == MONT_MUL ? 2
         : (p == SQR_REDC || p == REDC) ? 1
         : p == PARTIAL_X2 ? 8
         : 4;
}

// The naive parts, canonical in and out.
__device__ __forceinline__ void mont_mul_canonical(const uint32_t* a,
                                                   const uint32_t* b,
                                                   uint32_t r[bn::NL]) {
  bn::mont_mul(a, b, r);                     // < 1.19p
  bn::reduce(r, BN_P);
}

// s <- the dense MDS mix, one reduction per row: < 1.76p, then canonical.
__device__ __forceinline__ void mds(uint32_t s[bn::WIDTH][bn::NL]) {
  uint32_t out[bn::WIDTH][bn::NL];
#pragma unroll
  for (int f = 0; f < bn::WIDTH; ++f) {
    bn::dot4(&BN_MDS[f * bn::WIDTH * bn::NL], s, out[f]);
    bn::reduce(out[f], BN_P);
  }
#pragma unroll
  for (int f = 0; f < bn::WIDTH; ++f) {
#pragma unroll
    for (int j = 0; j < bn::NL; ++j) s[f][j] = out[f][j];
  }
}

// Naive partial round r: every element plus its round constant, the S-box
// of element 0, the dense mix.
__device__ __forceinline__ void partial_round(uint32_t s[bn::WIDTH][bn::NL],
                                              int r) {
#pragma unroll
  for (int e = 0; e < bn::WIDTH; ++e)
    bn::add_const(s[e], &BN_RC[(r * bn::WIDTH + e) * bn::NL]);  // canonical
  bn::sbox(s[0]);
  bn::reduce(s[0], BN_P);
  mds(s);
}

template <int PROBE>
__device__ __forceinline__ void step(uint32_t (*s)[bn::NL], int i) {
  if constexpr (PROBE == SQR_REDC) {
    mont_mul_canonical(s[0], s[0], s[0]);
  } else if constexpr (PROBE == MONT_MUL) {
    mont_mul_canonical(s[0], s[1], s[0]);
  } else if constexpr (PROBE == REDC) {
    bn::from_mont(s[0]);
  } else if constexpr (PROBE == MIX) {
    mds(s);
  } else if constexpr (PROBE == PARTIAL) {
    partial_round(s, BN_HALF_FULL_ROUNDS + i % BN_PARTIAL_ROUNDS);
  } else if constexpr (PROBE == PARTIAL_X2) {
    const int r = BN_HALF_FULL_ROUNDS + i % BN_PARTIAL_ROUNDS;
    partial_round(s, r);
    partial_round(s + 4, r);
  } else {
    bn::permute(s);
    bn::canonical(s);
  }
}

template <int PROBE, int THREADS>
__global__ void __launch_bounds__(THREADS,
                                  (PROBE == PARTIAL_X2 ? 256 : 512) / THREADS)
    bn254_micro_kernel(const uint64_t* __restrict__ in,
                       uint64_t* __restrict__ out, int64_t n, int chain) {
  const int64_t lane = blockIdx.x * (int64_t)THREADS + threadIdx.x;
  if (lane >= n) return;
  if constexpr (PROBE == U32_MUL16) {
    uint32_t x = (uint32_t)(in[lane] & 0xFFFF);
#pragma unroll 1
    for (int i = 0; i < chain; ++i) {
#pragma unroll
      for (uint32_t j = 0; j < 16; ++j) x = ((x * (x ^ j)) & 0xFFFFu) | 1u;
    }
    out[lane] = x;
  } else if constexpr (PROBE == F32_MUL16) {
    float x = (float)(uint32_t)(in[lane] & 0xFFFF);
#pragma unroll 1
    for (int i = 0; i < chain; ++i) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        x = fmodf(__fmul_rn(x, x + (float)(j + 1)), 65536.0f) + 1.0f;
    }
    out[lane] = (uint64_t)x;
  } else {
    constexpr int E = probe_elems(PROBE);
    uint32_t s[E][bn::NL];
#pragma unroll
    for (int e = 0; e < E; ++e) bn::load(in + e * 4 * n + lane, n, s[e]);
#pragma unroll 1
    for (int i = 0; i < chain; ++i) step<PROBE>(s, i);
#pragma unroll
    for (int e = 0; e < E; ++e) bn::store(out + e * 4 * n + lane, n, s[e]);
  }
}

template <int PROBE, int THREADS>
static void launch(const void* in, void* out, long long n, int chain,
                   cudaStream_t stream) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  bn254_micro_kernel<PROBE, THREADS><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const uint64_t*)in, (uint64_t*)out, (int64_t)n, chain);
}

// threads must be 128, or 256 or 512 for PERMUTE.
extern "C" int launch_bn254_micro(const void* in, void* out, int probe,
                                  int chain, long long n, int threads,
                                  void* stream) {
  if (chain < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (threads != 128 && !(probe == PERMUTE && (threads == 256 ||
                                               threads == 512)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (probe) {
    case SQR_REDC: launch<SQR_REDC, 128>(in, out, n, chain, s); break;
    case MONT_MUL: launch<MONT_MUL, 128>(in, out, n, chain, s); break;
    case REDC: launch<REDC, 128>(in, out, n, chain, s); break;
    case MIX: launch<MIX, 128>(in, out, n, chain, s); break;
    case PARTIAL: launch<PARTIAL, 128>(in, out, n, chain, s); break;
    case PARTIAL_X2: launch<PARTIAL_X2, 128>(in, out, n, chain, s); break;
    case PERMUTE:
      if (threads == 128) launch<PERMUTE, 128>(in, out, n, chain, s);
      else if (threads == 256) launch<PERMUTE, 256>(in, out, n, chain, s);
      else launch<PERMUTE, 512>(in, out, n, chain, s);
      break;
    case U32_MUL16: launch<U32_MUL16, 128>(in, out, n, chain, s); break;
    case F32_MUL16: launch<F32_MUL16, 128>(in, out, n, chain, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
